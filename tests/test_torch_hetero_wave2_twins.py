"""The hpn, iehgcn, rohehan and heco trainer twins
(`gammagl_tpu_torch/examples/`) against the JAX trainers, on the
synthetic graphs the JAX trainers fall back to: the twins' losses rtol
1e-5 over 3 steps, and the linear probe's accuracy exactly.
"""
import argparse
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.datasets as jax_datasets  # noqa: E402
import gammagl_tpu.models as jmodels  # noqa: E402
from examples.common import linear_probe as jax_linear_probe  # noqa: E402
from examples.common import (  # noqa: E402
    synthetic_hetero as jax_synthetic_hetero)
from examples.hpn import hpn_trainer as jax_hpn  # noqa: E402
from examples.iehgcn import iehgcn_trainer as jax_iehgcn  # noqa: E402
from examples.rohehan import rohehan_trainer as jax_rohehan  # noqa: E402
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402

from gammagl_tpu_torch.examples import (common, heco_trainer,  # noqa: E402
                                        hpn_trainer, iehgcn_trainer,
                                        rohehan_trainer)


def _no_dataset(*args, **kwargs):
    raise OSError("no dataset files in the tree")


TYPED_TWINS = {"hpn": (hpn_trainer, jax_hpn),
               "iehgcn": (iehgcn_trainer, jax_iehgcn),
               "rohehan": (rohehan_trainer, jax_rohehan)}


@pytest.mark.parametrize("name", sorted(TYPED_TWINS))
def test_typed_twin_matches_the_jax_trainer(name, monkeypatch):
    """The JAX trainer's model (captured from its ``main``, its IMDB
    loader made to fail, so it falls back to the synthetic graph the twin
    trains on) and 3 steps of its loop give the twin's losses."""
    module, jmod = TYPED_TWINS[name]
    monkeypatch.setattr(jax_datasets, "IMDB", _no_dataset)
    monkeypatch.setattr(jmod, "run_hetero_trainer",
                        lambda make, args, dataset_loader=None: make)
    targs = module.parser().parse_args(["--device", "cpu", "--n_epoch",
                                        "3"])
    jargs = argparse.Namespace(**{k: v for k, v in vars(targs).items()
                                  if k != "device"})
    with pytest.raises(OSError):
        jmod.load_imdb(jargs)
    jhg, target = jax_synthetic_hetero()
    jhg = jhg.tensor()
    jmodel = jmod.main(jargs)(jhg.metadata(), 3, target)
    key = jax.random.PRNGKey(targs.seed)
    params = jmodel.init({"params": key, "dropout": key}, jhg.x_dict,
                         jhg.edge_index_dict)
    y = jnp.asarray(np.asarray(jhg[target].y))
    mask = jnp.asarray(np.asarray(jhg[target].train_mask))
    state = JaxTrainState.create(params=params, tx=optax.adam(targs.lr))
    step = jax.jit(lambda s: (lambda loss, g: (s.apply_gradients(g), loss))(
        *jax.value_and_grad(lambda p: jax_loss(jmodel.apply(
            p, jhg.x_dict, jhg.edge_index_dict), y, mask))(s.params)))
    want = []
    for _ in range(3):
        state, loss = step(state)
        want.append(float(loss))
    got = module.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def test_heco_twin_matches_the_jax_trainer():
    """The JAX heco trainer's graph, positives and model, 3 of its steps
    (Adam on the contrastive loss) against the twin's; then the twin's
    probe equals `linear_probe` of the JAX package on the same
    embeddings."""
    targs = heco_trainer.parser().parse_args(["--device", "cpu",
                                              "--n_epoch", "3"])
    jhg, _ = jax_synthetic_hetero()
    jt = jhg.tensor()
    x_dict = {"movie": jt["movie"].x, "director": jt["director"].x}
    ei_dict = {heco_trainer.SCHEMA: jt[heco_trainer.SCHEMA].edge_index}
    mp = [jt[heco_trainer.METAPATH].edge_index]
    mdm = np.asarray(jhg[heco_trainer.METAPATH].edge_index)
    pos = np.eye(200, dtype=bool)
    pos[mdm[0], mdm[1]] = True
    jm = jmodels.HeCoModel((["movie", "director"], [heco_trainer.SCHEMA]),
                           "movie", hidden_dim=targs.hidden_dim,
                           feat_drop=0.0)
    params = jm.init(jax.random.PRNGKey(targs.seed), x_dict, ei_dict, mp,
                     jnp.asarray(pos))
    state = JaxTrainState.create(params=params, tx=optax.adam(targs.lr))
    step = jax.jit(lambda s: (lambda loss, g: (s.apply_gradients(g), loss))(
        *jax.value_and_grad(lambda p: jm.apply(
            p, x_dict, ei_dict, mp, jnp.asarray(pos)))(s.params)))
    want = []
    for _ in range(3):
        state, loss = step(state)
        want.append(float(loss))
    got = heco_trainer.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    emb = common.predict(got["model"], *heco_trainer.heco_inputs(
        common.synthetic_hetero()[0], "cpu")[:2],
        metapath_edges=[torch.tensor(mdm)])
    d = {k: np.asarray(jhg["movie"][k]) for k in ("y", "train_mask",
                                                  "test_mask")}
    want_acc = jax_linear_probe(jnp.asarray(emb.numpy()),
                                {k: jnp.asarray(v) for k, v in d.items()},
                                3)
    assert got["test_acc"] == pytest.approx(want_acc, abs=1e-6)


TWINS = {"hpn": hpn_trainer, "iehgcn": iehgcn_trainer,
         "rohehan": rohehan_trainer, "heco": heco_trainer}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_trains_on_the_cpu(name, capsys):
    module = TWINS[name]
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch",
                                       "8"])
    out = module.main(args)
    losses = out["losses"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] and 0.0 <= out["test_acc"] <= 1.0
    assert "acc" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_defaults_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    before it builds anything, rather than falling back to the CPU."""
    module = TWINS[name]
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]))
