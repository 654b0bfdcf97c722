"""The propagation zoo's trainer twins (`gammagl_tpu_torch/examples/`)
against the JAX trainers of `examples/<name>/<name>_trainer.py`.

The twins run 3 steps of their loop with dropout off (dropout masks come
from different generators in the two packages) against the JAX trainers'
step: rtol 1e-4 (the twin sums on its plan route, the JAX trainer on XLA
off a TPU), 1e-5 for the gin twin, whose model takes no plan.
"""

import ast
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import examples.common as jax_common  # noqa: E402
import gammagl_tpu.models as jmodels  # noqa: E402
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa

import gammagl_tpu_torch.models as tmodels  # noqa: E402
from gammagl_tpu_torch.examples import (  # noqa: E402
    agnn_trainer, appnp_trainer, chebnet_trainer, common, fagcn_trainer,
    gcnii_trainer, gin_trainer, gprgnn_trainer, hid_net_trainer,
    jknet_trainer, mixhop_trainer, sgc_trainer)
from gammagl_tpu_torch.train import semi_supervised_loss  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402
from tests.test_torch_simple_convs import _check, _np_tree  # noqa: E402


# the twins of examples/<name>/<name>_trainer.py on run_simple_node_trainer
# (HiD-Net's model is in `models/wave3_models.py`, its conv in
# `layers/conv/hetero_wave2.py`)
TWINS = {"sgc": sgc_trainer, "appnp": appnp_trainer, "gcnii": gcnii_trainer,
         "jknet": jknet_trainer, "chebnet": chebnet_trainer,
         "mixhop": mixhop_trainer, "gprgnn": gprgnn_trainer,
         "fagcn": fagcn_trainer, "agnn": agnn_trainer, "gin": gin_trainer,
         "hid_net": hid_net_trainer}


def jax_twin(name):
    """The JAX trainer module of ``name`` and its command line's defaults
    (``base_parser(...)`` of its ``__main__`` block, read by AST)."""
    import importlib
    path = osp.join(osp.dirname(__file__), "..", "examples", name,
                    f"{name}_trainer.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    overrides = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "base_parser"):
            overrides = {k.arg: ast.literal_eval(k.value)
                         for k in node.keywords}
    module = importlib.import_module(f"examples.{name}.{name}_trainer")
    return module, jax_common.base_parser(**overrides).parse_args([])


def _tiny_data(seed=3):
    return common.synthetic_community_graph(num_nodes=60, num_classes=4,
                                            feat_dim=12, avg_degree=4,
                                            seed=seed)


def jax_losses(model, data, args, n_steps):
    """n_steps of the JAX trainers' step (`examples/common.py`
    `run_simple_node_trainer`: Adam with decayed weights on the masked
    cross-entropy, ``train=True``) from the model's init at
    ``args.seed``; returns (losses, the initial flax variables)."""
    n = data["x"].shape[0]
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    x, jei = jnp.asarray(data["x"]), jnp.asarray(ei)
    y, mask = jnp.asarray(data["y"]), jnp.asarray(data["train_mask"])
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key}, x, jei)
    tx = optax.chain(optax.add_decayed_weights(args.l2_coef),
                     optax.adam(args.lr))
    state = JaxTrainState.create(params=params, tx=tx)

    @jax.jit
    def step(state, x, ei, y, mask):
        loss, grads = jax.value_and_grad(lambda p: jax_loss(model.apply(
            p, x, ei, train=True, rngs={"dropout": key}), y, mask))(
            state.params)
        return state.apply_gradients(grads), loss

    losses = []
    for _ in range(n_steps):
        state, loss = step(state, x, jei, y, mask)
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_matches_the_jax_trainer(name, monkeypatch):
    """The twin's flags are the JAX trainer's (its defaults and
    overrides), it builds the model the JAX trainer builds (captured from
    the JAX ``main``), and 3 steps of its loop with dropout off give the
    JAX trainer's losses."""
    module = TWINS[name]
    jmod, jargs = jax_twin(name)
    targs = module.parser().parse_args(["--device", "cpu"])
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)
    data = _tiny_data(8)
    n_class = int(data["y"].max()) + 1
    monkeypatch.setattr(jmod, "probe_num_classes", lambda args: n_class)
    monkeypatch.setattr(jmod, "run_simple_node_trainer",
                        lambda model, args, **kw: model)
    jargs.drop_rate = targs.drop_rate = 0.0
    targs.n_epoch = 3
    jmodel = jmod.main(jargs)
    want, params = jax_losses(jmodel, data, jargs, 3)
    got = module.main(targs, data=data, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want,
                               rtol=1e-5 if name == "gin" else 1e-4)


def test_gin_twin_scores_the_whole_graph_as_jax_c18():
    """ROADMAP C18: the gin twin trains GINModel, a graph readout, on a
    node task with no batch vector, so every node gets the same one row
    of logits, (1, C), in both packages, and the loss broadcasts it to
    every label (C17)."""
    data = _tiny_data(9)
    n = data["x"].shape[0]
    jm = jmodels.GINModel(32, 4, num_layers=2, drop_rate=0.0)
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    key = jax.random.PRNGKey(0)
    params = _np_tree(jm.init({"params": key, "dropout": key},
                              jnp.asarray(data["x"]), jnp.asarray(ei)))
    want = jm.apply(params, jnp.asarray(data["x"]), jnp.asarray(ei))
    model = load_jax_params(tmodels.GINModel(32, 4, num_layers=2), params)
    got = common.predict(model, torch.tensor(data["x"]), torch.tensor(ei))
    assert want.shape == got.shape == (1, 4)
    _check(got, want, 1e-5)
    y, mask = torch.tensor(data["y"]), torch.tensor(data["train_mask"])
    np.testing.assert_allclose(
        float(semi_supervised_loss(got, y, mask)),
        float(jax_loss(want, jnp.asarray(data["y"]),
                       jnp.asarray(data["train_mask"]))), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_trains_on_the_cpu_with_dropout(name, capsys):
    """The twin's own init and its dropout on: the run ends, the losses
    are finite, the accuracies are fractions."""
    module = TWINS[name]
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch", "4"])
    out = module.main(args, data=_tiny_data(10))
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["best_test"] <= 1.0
    assert "best val" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_defaults_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    rather than falling back to the CPU."""
    module = TWINS[name]
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]),
                    data=_tiny_data(11))
