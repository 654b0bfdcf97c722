"""The port's HPN, ieHGCN, HiD-Net and RoheHAN models
(`models/wave3_models.py`) and HeCo (`models/heco.py`) against the JAX
package, on the graphs of `test_torch_hetero_wave2.py`: each model filled
from the JAX model's own ``init`` tree, float32 outputs at 1e-5 of max
|out|, gradients at 1e-4 of each parameter's max |grad|.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.models as jmodels  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from tests.test_torch_hetero_wave2 import _graph  # noqa: E402
from tests.test_torch_simple_convs import (  # noqa: E402
    _check, _check_grads, _jax_out_and_grads, _np_tree)

import gammagl_tpu_torch.models as tmodels  # noqa: E402
from gammagl_tpu_torch.examples import common, heco_trainer  # noqa: E402
from gammagl_tpu_torch.train import semi_supervised_loss  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402


def _labels(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, n), rng.random(n) < 0.5


@pytest.mark.parametrize("name", ["hpn", "iehgcn", "rohehan", "rohe_alias",
                                  "hpn_alias"])
def test_typed_model_matches_jax_with_its_params(name):
    """Each model (and the reference's alias of it) filled from the JAX
    model's own init tree: logits of the target type and the gradients of
    the masked cross-entropy."""
    meta, jx, jei, tx, tei = _graph(1)
    make = {"hpn": (jmodels.HPNModel, tmodels.HPNModel, {}),
            "hpn_alias": (jmodels.HPNModel, tmodels.HPN, {}),
            "iehgcn": (jmodels.ieHGCNModel, tmodels.ieHGCNModel, {}),
            "rohehan": (jmodels.RoheHANModel, tmodels.RoheHANModel,
                        {"heads": 2}),
            "rohe_alias": (jmodels.RoheHANModel, tmodels.RoheHAN,
                           {"heads": 2})}[name]
    jm = make[0](meta, 8, 3, "movie", **make[2])
    key = jax.random.PRNGKey(6)
    params = _np_tree(jm.init({"params": key, "dropout": key}, jx, jei))
    y, mask = _labels(200)
    want, jgrads = _jax_out_and_grads(
        lambda p: jm.apply(p, jx, jei),
        lambda out: jax_loss(out, jnp.asarray(y), jnp.asarray(mask)), params)
    model = load_jax_params(make[1](meta, 8, 3, "movie", **make[2]),
                            params).eval()
    got = model(tx, tei)
    _check(got, want, 1e-5)
    semi_supervised_loss(got, torch.tensor(y), torch.tensor(mask)).backward()
    _check_grads(model, jgrads, 1e-4)


@pytest.mark.parametrize("name", ["HiDNetModel", "Hid_net"])
def test_hidnet_model_matches_jax(name):
    rng = np.random.default_rng(7)
    n = 40
    ei = np.stack([rng.integers(0, n, 150), rng.integers(0, n - 8, 150)])
    x = rng.normal(size=(n, 10)).astype(np.float32)
    jm = jmodels.HiDNetModel(8, 3, num_layers=3)
    key = jax.random.PRNGKey(8)
    jx, jei = jnp.asarray(x), jnp.asarray(ei)
    params = _np_tree(jm.init({"params": key, "dropout": key}, jx, jei))
    y, mask = _labels(n)
    want = jm.apply(params, jx, jei)
    jgrads = jax.grad(lambda p: jax_loss(jm.apply(p, jx, jei),
                                         jnp.asarray(y),
                                         jnp.asarray(mask)))(params)
    model = load_jax_params(getattr(tmodels, name)(8, 3, num_layers=3),
                            params).eval()
    got = model(torch.tensor(x), torch.tensor(ei))
    _check(got, want, 1e-5)
    semi_supervised_loss(got, torch.tensor(y), torch.tensor(mask)).backward()
    _check_grads(model, jgrads, 1e-4)


def _heco_case(num_metapaths=2):
    """HeCo on the synthetic graph: the directs relation as the schema,
    the movie-director-movie relation (and, for two metapaths, its first
    half again) as metapaths, positives the metapath pairs and the
    diagonal."""
    hg, _ = common.synthetic_hetero(2)
    x_dict, ei_dict, mp, pos = heco_trainer.heco_inputs(hg, "cpu")
    mp = (mp * 2)[:num_metapaths]
    if num_metapaths == 2:
        mp[1] = mp[1][:, :mp[1].shape[1] // 2]
    meta = (["movie", "director"], [heco_trainer.SCHEMA])
    jx = {k: jnp.asarray(v.numpy()) for k, v in x_dict.items()}
    jei = {k: jnp.asarray(v.numpy()) for k, v in ei_dict.items()}
    jmp = [jnp.asarray(e.numpy()) for e in mp]
    return meta, (x_dict, ei_dict, mp, pos), (jx, jei, jmp,
                                              jnp.asarray(pos.numpy()))


@pytest.mark.parametrize("name", ["HeCoModel", "HeCo"])
def test_heco_matches_jax(name):
    """The contrastive loss (with the positives) and the metapath view's
    embeddings (without), filled from the JAX init tree, with the
    gradients of the loss; two metapaths."""
    meta, (x, ei, mp, pos), (jx, jei, jmp, jpos) = _heco_case()
    jm = jmodels.HeCoModel(meta, "movie", hidden_dim=8, feat_drop=0.0)
    params = _np_tree(jm.init(jax.random.PRNGKey(9), jx, jei, jmp, jpos))
    want_loss, jgrads = _jax_out_and_grads(
        lambda p: jm.apply(p, jx, jei, jmp, jpos), lambda out: out, params)
    want_emb = jax.jit(jm.apply)(params, jx, jei, jmp)
    model = load_jax_params(getattr(tmodels, name)(
        meta, "movie", hidden_dim=8, feat_drop=0.0, num_metapaths=2),
        params)
    loss = model(x, ei, mp, pos)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    loss.backward()
    _check_grads(model, jgrads, 1e-4)
    with torch.no_grad():
        _check(model(x, ei, mp), want_emb, 1e-5)
    with pytest.raises(ValueError, match="metapath graphs"):
        model(x, ei, mp[:1], pos)


def test_heco_contrast_loss_matches_jax():
    rng = np.random.default_rng(10)
    z1, z2 = (rng.normal(size=(25, 6)).astype(np.float32) for _ in range(2))
    pos = rng.random((25, 25)) < 0.2
    np.fill_diagonal(pos, True)
    for tau, lam in ((0.8, 0.5), (0.3, 0.9)):
        want = jmodels.heco_contrast_loss(jnp.asarray(z1), jnp.asarray(z2),
                                          jnp.asarray(pos), tau, lam)
        got = tmodels.heco_contrast_loss(torch.tensor(z1), torch.tensor(z2),
                                         torch.tensor(pos), tau, lam)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_mode_dropout_is_drawn_from_the_generator():
    """HeCo's feature dropout in training mode: one generator state gives
    one loss; another state another."""
    meta, (x, ei, mp, pos), _ = _heco_case(1)
    torch.manual_seed(11)
    model = tmodels.HeCoModel(meta, "movie", hidden_dim=8, feat_drop=0.3,
                              in_channels=32).train()
    with torch.no_grad():
        losses = [float(model(x, ei, mp, pos,
                              generator=torch.Generator().manual_seed(s)))
                  for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
