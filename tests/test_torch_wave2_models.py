"""The port's wave-2 models (`models/wave2_models.py`: PNAModel,
CompGCNModel, DGCNNModel, GaANModel) against the JAX package's, on the
CPU, with the parameters carried over by `load_jax_params`; and the flax
``Conv`` round trip of `load_jax_params` (its kernel's axes reversed into
an ``nn.Conv1d`` weight).

Each model runs the same numpy inputs (from a seed), forward and the
gradients of sum(out * g) for a fixed g in every parameter and in x,
under one jitted ``value_and_grad`` on the JAX side. Tolerances, float32:
1e-5 of max |out| (each gradient's own max |grad|). The graph leaves its
last rows without edges (PNA's gets self-loops, below); DGCNN's features
are 0s and 1s, so its EdgeConvs' maxima tie.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.models as jmodels  # noqa: E402
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _jax_out_and_grads, _np_tree)

import gammagl_tpu_torch.models as tmodels  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402


def _inputs(seed=0, n=30, e=110, f=7):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 6, e)])
    x = rng.normal(size=(n, f)).astype(np.float32)
    return ei, x, rng


def _case(name):
    """(JAX model, port model, JAX extra inputs, port extra inputs,
    ei, x)."""
    if name == "pna":
        # with self-loops, as the twins train it: a row of no in-edges
        # has a zero degree, and PNA's attenuation 1 / max(log(1), 1e-5)
        # lifts its std entry, sqrt(0 + 1e-5), to ~316; the next layer's
        # std, sqrt(E[x^2] - E[x]^2 + 1e-5), then cancels among rows that
        # large, and the f32 rounding of the first layer's products
        # (different in XLA and torch) shows at ~2e-5 of max |out| in both
        # packages alike. The convs' test covers rows of no in-edges.
        ei, x, _ = _inputs(0)
        n = x.shape[0]
        ei = np.concatenate([ei, np.stack([np.arange(n)] * 2)], axis=1)
        return (jmodels.PNAModel(hidden_dim=8, num_class=3),
                tmodels.PNAModel(hidden_dim=8, num_class=3).eval(), (), (),
                ei, x)
    if name == "gaan":
        ei, x, _ = _inputs(1)
        return (jmodels.GaANModel(hidden_dim=6, num_class=3, heads=2),
                tmodels.GaANModel(hidden_dim=6, num_class=3, heads=2), (),
                (), ei, x)
    if name == "compgcn":
        ei, x, rng = _inputs(2)
        et = rng.integers(0, 4, ei.shape[1])
        return (jmodels.CompGCNModel(4, hidden_dim=8, num_class=3),
                tmodels.CompGCNModel(4, hidden_dim=8, num_class=3),
                (jnp.asarray(et),), (torch.tensor(et),), ei, x)
    # dgcnn: three graphs of 10 nodes, k = 6 (one graph has fewer rows
    # than k after its own; the pool pads with zero rows)
    rng = np.random.default_rng(3)
    sizes = [10, 10, 4]
    off = np.cumsum([0] + sizes)
    eis = [rng.integers(0, s, (2, 3 * s)) + o for s, o in zip(sizes, off)]
    ei = np.concatenate(eis, axis=1)
    x = rng.integers(0, 2, (off[-1], 5)).astype(np.float32)
    batch = np.repeat(np.arange(3), sizes)
    return (jmodels.DGCNNModel(hidden_dim=6, num_class=2, k=6),
            tmodels.DGCNNModel(hidden_dim=6, num_class=2, k=6),
            (jnp.asarray(batch), 3), (torch.tensor(batch), 3), ei, x)


@pytest.mark.parametrize("name", ["pna", "gaan", "compgcn", "dgcnn"])
def test_model_matches_jax(name):
    jm, model, jextra, textra, ei, x = _case(name)
    jei = jnp.asarray(ei)
    params = _np_tree(jm.init(jax.random.PRNGKey(4), jnp.asarray(x), jei,
                              *jextra))
    load_jax_params(model, params)

    def f(p, jx):
        return jm.apply(p, jx, jei, *jextra)

    shape = (3 if name == "dgcnn" else x.shape[0],
             2 if name == "dgcnn" else 3)
    g = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    loss = lambda out: (out * jnp.asarray(g)).sum()  # noqa: E731
    if name == "dgcnn":  # its sort pool sizes the batch from the data
        want = f(params, jnp.asarray(x))
        grads = jax.grad(lambda p, jx: loss(f(p, jx)), argnums=(0, 1))(
            params, jnp.asarray(x))
    else:
        want, grads = _jax_out_and_grads(f, loss, params, jnp.asarray(x),
                                         argnums=(0, 1))
    tx = torch.tensor(x, requires_grad=True)
    got = model(tx, torch.tensor(ei), *textra)
    _check(got, want, 1e-5)
    (got * torch.tensor(g)).sum().backward()
    _check_grads(model, grads[0], 1e-5)
    _check(tx.grad, grads[1], 1e-5)


def test_lazy_models_take_their_width_from_x():
    """``in_channels=None``: the first forward sizes the lazy maps and
    CompGCN's relation embeddings (glorot-uniform, (R, F_in)), as flax's
    init does; the shapes are the JAX tree's."""
    ei, x, rng = _inputs(6)
    et = rng.integers(0, 4, ei.shape[1])
    model = tmodels.CompGCNModel(4, hidden_dim=8, num_class=3)
    model(torch.tensor(x), torch.tensor(ei), torch.tensor(et))
    params = jmodels.CompGCNModel(4, hidden_dim=8, num_class=3).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei),
        jnp.asarray(et))
    assert tuple(model.rel_emb.shape) == params["params"]["rel_emb"].shape
    lim = np.sqrt(6.0 / (4 + x.shape[1]))
    assert float(model.rel_emb.detach().abs().max()) <= lim
    load_jax_params(model, _np_tree(params))  # the same tree fits


def test_pna_dropout_draws_from_the_generator():
    """In training mode PNAModel's dropout draws from ``generator``: one
    seed gives one output, another seed another; eval mode is the JAX
    deterministic forward."""
    ei, x, _ = _inputs(7)
    model = tmodels.PNAModel(hidden_dim=8, num_class=3)
    args = (torch.tensor(x), torch.tensor(ei))
    model(*args)
    model.train()
    outs = [model(*args, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])


class _FlaxConvNet(fnn.Module):
    @fnn.compact
    def __call__(self, seq):
        return fnn.Conv(4, kernel_size=(3,), strides=(1,))(seq)


def test_flax_conv_round_trip():
    """A flax ``nn.Conv`` of one spatial axis (kernel (W, C_in, C_out),
    'SAME' padding) loads into an ``nn.Conv1d`` of padding W // 2 and
    gives its output on (B, L, C) sequences transposed to (B, C, L)."""
    rng = np.random.default_rng(8)
    seq = rng.normal(size=(2, 9, 5)).astype(np.float32)
    jm = _FlaxConvNet()
    params = _np_tree(jm.init(jax.random.PRNGKey(9), jnp.asarray(seq)))
    assert params["params"]["Conv_0"]["kernel"].shape == (3, 5, 4)
    want = jm.apply(params, jnp.asarray(seq))

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv1d(5, 4, 3, padding=1)

        def flax_tree(self):
            return {"Conv_0": self.conv}

    port = load_jax_params(Port(), params)
    np.testing.assert_array_equal(
        port.conv.weight.detach().numpy(),
        np.transpose(params["params"]["Conv_0"]["kernel"], (2, 1, 0)))
    with torch.no_grad():
        got = port.conv(torch.tensor(seq).transpose(1, 2)).transpose(1, 2)
    _check(got, want, 1e-5)
    bad = {"params": {"Conv_0": {"kernel": np.zeros((3, 4, 5), np.float32),
                                 "bias": np.zeros(4, np.float32)}}}
    with pytest.raises(ValueError, match="Conv_0/kernel"):
        load_jax_params(Port(), bad)
