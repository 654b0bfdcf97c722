"""The port's HPN, ieHGCN, HiD-Net and RoheHAN convolutions
(`layers/conv/hetero_wave2.py`) against the JAX package, on the JAX
trainers' synthetic movie/director graph; their models and HeCo are held
in `test_torch_hetero_wave2_models.py`, the hpn, iehgcn, rohehan and heco
trainer twins in `test_torch_hetero_wave2_twins.py`.

All of them are COO in both packages (no plan, no kernel). Each case
fills the port module from the JAX module's own ``init`` tree with
`load_jax_params`. Tolerances, float32: 1e-5 of max |out|, gradients
1e-4 of each parameter's max |grad|.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.layers.conv as jconv  # noqa: E402
from examples.common import (  # noqa: E402
    synthetic_hetero as jax_synthetic_hetero)
from tests.test_torch_simple_convs import (  # noqa: E402
    _check, _check_grads, _jax_out_and_grads, _np_tree)

import gammagl_tpu_torch.layers.conv as tconv  # noqa: E402
from gammagl_tpu_torch.examples import common  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402


def _graph(seed=0):
    """The synthetic typed graph from both packages (the same arrays), as
    JAX and torch inputs."""
    jhg, target = jax_synthetic_hetero(seed)
    hg, target2 = common.synthetic_hetero(seed)
    assert target == target2 == "movie"
    x = {nt: np.asarray(v, np.float32) for nt, v in hg.x_dict.items()}
    ei = dict(hg.edge_index_dict)
    for nt in x:
        np.testing.assert_array_equal(x[nt], np.asarray(jhg[nt].x))
    return (hg.metadata(), {k: jnp.asarray(v) for k, v in x.items()},
            {k: jnp.asarray(v) for k, v in ei.items()},
            {k: torch.tensor(v) for k, v in x.items()},
            {k: torch.tensor(v) for k, v in ei.items()})


def _trust(ei_dict, seed=1):
    """Trust scores for the movie-director-movie relation: about a third
    of its edges untrusted (<= 0)."""
    et = ("movie", "mdm", "movie")
    t = np.random.default_rng(seed).random(ei_dict[et].shape[1]) - 0.33
    return {et: t.astype(np.float32)}


# name -> (JAX conv, port conv, JAX call keywords, port call keywords)
def _convs(meta, trust):
    return {
        "hpn": (jconv.HPNConv(6, meta, iter_K=2, alpha=0.2),
                tconv.HPNConv(32, 6, meta, iter_K=2, alpha=0.2), {}, {}),
        "iehgcn": (jconv.ieHGCNConv(6, meta, attn_channels=5),
                   tconv.ieHGCNConv(32, 6, meta, attn_channels=5), {}, {}),
        "rohehan": (jconv.RoheHANConv(4, meta, heads=2),
                    tconv.RoheHANConv(32, 4, meta, heads=2), {}, {}),
        "rohehan_trust": (
            jconv.RoheHANConv(4, meta, heads=2),
            tconv.RoheHANConv(32, 4, meta, heads=2),
            {"trust_dict": {k: jnp.asarray(v) for k, v in trust.items()}},
            {"trust_dict": {k: torch.tensor(v) for k, v in trust.items()}}),
    }


@pytest.mark.parametrize("name", ["hpn", "iehgcn", "rohehan",
                                  "rohehan_trust"])
def test_typed_conv_matches_jax(name):
    """Every node type's output and the gradients of sum_t sum(out_t *
    g_t) in the parameters and in the features."""
    meta, jx, jei, tx, tei = _graph()
    trust = _trust(tei)
    jm, conv, jkw, tkw = _convs(meta, trust)[name]
    params = _np_tree(jm.init(jax.random.PRNGKey(2), jx, jei, **jkw))
    def fwd(p, xs):
        return jm.apply(p, xs, jei, **jkw)

    rng = np.random.default_rng(3)
    gs = {nt: rng.normal(size=v.shape).astype(np.float32)
          for nt, v in jax.eval_shape(fwd, params, jx).items()}
    want, (jgrads, jdx) = _jax_out_and_grads(
        fwd, lambda out: sum((out[nt] * jnp.asarray(g)).sum()
                             for nt, g in gs.items()),
        params, jx, argnums=(0, 1))
    load_jax_params(conv, params)
    tx = {nt: v.clone().requires_grad_() for nt, v in tx.items()}
    got = conv(tx, tei, **tkw)
    assert sorted(got) == sorted(want)
    for nt in want:
        _check(got[nt], want[nt], 1e-5)
    sum((got[nt] * torch.tensor(g)).sum() for nt, g in gs.items()).backward()
    _check_grads(conv, jgrads, 1e-4)
    for nt in tx:
        _check(tx[nt].grad, jdx[nt], 1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_hid_conv_matches_jax(weighted):
    """HidConv's two COO hops and its gate, rows without edges included,
    with and without edge weights; forward and the gradients in x and
    origin."""
    rng = np.random.default_rng(4)
    n = 30
    ei = np.stack([rng.integers(0, n, 90), rng.integers(0, n - 5, 90)])
    x, origin = (rng.normal(size=(n, 6)).astype(np.float32)
                 for _ in range(2))
    w = rng.random(90).astype(np.float32) + 0.5 if weighted else None
    jm = jconv.HidConv(alpha=0.2, beta=0.7, gamma=0.4, sigma=0.6)
    jw = None if w is None else jnp.asarray(w)

    def apply(jx, jo):
        return jm.apply({}, jx, jo, jnp.asarray(ei), jw)

    want = apply(jnp.asarray(x), jnp.asarray(origin))
    g = rng.normal(size=want.shape).astype(np.float32)
    jdx, jdo = jax.grad(lambda a, b: (apply(a, b) * jnp.asarray(g)).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(origin))
    conv = tconv.Hid_conv(alpha=0.2, beta=0.7, gamma=0.4, sigma=0.6)
    tx, to = (torch.tensor(a, requires_grad=True) for a in (x, origin))
    got = conv(tx, to, torch.tensor(ei),
               None if w is None else torch.tensor(w))
    _check(got, want, 1e-5)
    (got * torch.tensor(g)).sum().backward()
    _check(tx.grad, jdx, 1e-4)
    _check(to.grad, jdo, 1e-4)
