"""The port's wave-2 convs (`layers/conv/wave2_convs.py`) against the JAX
package's, on the CPU, and the quirks C21 and C22 (ROADMAP section C).

Each case builds the JAX conv's parameters with its own ``init``, carries
them across with `load_jax_params`, and runs the same numpy inputs (from
a seed) through both packages, forward and the gradients of sum(out * g)
for a fixed g in every parameter and in the inputs (x, or x_all, the
pseudo-coordinates, the relation embeddings). The JAX side is one jitted
``value_and_grad`` a case. The convs take no plan in either package, so
both run their COO ops. Three graphs:

* ``pad``: random edges whose destinations leave the last rows without
  edges, plus padded edges whose ids are out of range (their source is
  gathered clamped, their destination drops the message);
* ``empty``: no edges (E = 0);
* ``ties``: inputs of 0s and 1s, so maxima and minima tie among many
  edges and the gradients of the max / min are shared among the ties.

Tolerances, float32, relative to max |out| (each gradient's own max
|grad|): 1e-5.
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
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _jax_out_and_grads, _np_tree)

import gammagl_tpu_torch.layers.conv as tconv  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

N, F_IN, F_OUT = 24, 6, 5


def _graph(kind, seed=0):
    """(edge_index, n): see the module docstring."""
    rng = np.random.default_rng(seed)
    if kind == "empty":
        return np.zeros((2, 0), np.int64), N
    ei = np.stack([rng.integers(0, N, 90), rng.integers(0, N - 5, 90)])
    if kind == "pad":
        pad = np.full((2, 6), N)
        pad[0, :3] = rng.integers(0, N, 3)  # a real source, a pad dst
        ei = np.concatenate([ei, pad], axis=1)
    return ei, N


def _features(kind, shape, rng):
    if kind == "ties":
        return rng.integers(0, 2, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


# name -> (JAX conv, port conv, inputs(kind, ei, rng) -> (extra JAX
# inputs, extra port inputs) after edge_index, whether the first input
# is x_all, keyword arguments of both calls)
def _no_extra(kind, ei, rng):
    return (), ()


def _edge_types(kind, ei, rng):
    et = rng.integers(0, 3, ei.shape[1])
    return (jnp.asarray(et),), (torch.tensor(et),)


def _pseudo(kind, ei, rng):
    p = rng.random((ei.shape[1], 2)).astype(np.float32)
    return (jnp.asarray(p),), (torch.tensor(p, requires_grad=True),)


def _comp(kind, ei, rng):
    et = rng.integers(0, 3, ei.shape[1])
    rel = _features(kind, (3, F_IN), rng)
    return ((jnp.asarray(et), jnp.asarray(rel)),
            (torch.tensor(et), torch.tensor(rel, requires_grad=True)))


CONVS = {
    "pna": (lambda: jconv.PNAConv(F_OUT),
            lambda: tconv.PNAConv(F_IN, F_OUT), _no_extra, {}),
    "pna_sum": (lambda: jconv.PNAConv(F_OUT, aggregators=("sum", "max"),
                                      scalers=("attenuation",),
                                      avg_deg_log=2.0),
                lambda: tconv.PNAConv(F_IN, F_OUT,
                                      aggregators=("sum", "max"),
                                      scalers=("attenuation",),
                                      avg_deg_log=2.0), _no_extra, {}),
    "film": (lambda: jconv.FILMConv(F_OUT),
             lambda: tconv.FILMConv(F_IN, F_OUT), _no_extra, {}),
    "film3": (lambda: jconv.FILMConv(F_OUT, num_relations=3),
              lambda: tconv.FILMConv(F_IN, F_OUT, num_relations=3),
              _edge_types, {}),
    "edge": (lambda: jconv.EdgeConv(F_OUT),
             lambda: tconv.EdgeConv(F_IN, F_OUT), _no_extra, {}),
    "gmm": (lambda: jconv.GMMConv(F_OUT, dim=2, kernel_size=3),
            lambda: tconv.GMMConv(F_IN, F_OUT, dim=2, kernel_size=3),
            _pseudo, {}),
    "comp_sub": (lambda: jconv.CompConv(F_OUT),
                 lambda: tconv.CompConv(F_IN, F_OUT), _comp, {}),
    "comp_mult": (lambda: jconv.CompConv(F_OUT, op="mult"),
                  lambda: tconv.CompConv(F_IN, F_OUT, op="mult"), _comp,
                  {}),
    "gaan": (lambda: jconv.GaANConv(F_OUT, heads=3),
             lambda: tconv.GaANConv(F_IN, F_OUT, heads=3), _no_extra, {}),
    "dna": (lambda: jconv.DNAConv(heads=2),
            lambda: tconv.DNAConv(F_IN, heads=2), _no_extra, {}),
    "hcha": (lambda: jconv.HypergraphConv(F_OUT),
             lambda: tconv.HypergraphConv(F_IN, F_OUT), _no_extra,
             {"num_edges": N}),
}


def _loss(out, g):
    if isinstance(out, tuple):  # CompConv: (nodes, relations)
        return sum((o * gg).sum() for o, gg in zip(out, g))
    return (out * g).sum()


@pytest.mark.parametrize("kind", ["pad", "empty", "ties"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_jax(name, kind):
    make_jax, make_port, extra, kw = CONVS[name]
    ei, n = _graph(kind)
    rng = np.random.default_rng(1)
    x = _features(kind, (n, 3, F_IN) if name == "dna" else (n, F_IN), rng)
    jextra, textra = extra(kind, ei, rng)
    tkw = kw
    if name == "hcha" and kind == "ties":
        # the port's default num_edges: one read of the hyperedge ids (the
        # JAX layer's int() of them does not trace, so JAX is given it)
        kw, tkw = {"num_edges": int(ei[1].max()) + 1}, {}
    jm, jei = make_jax(), jnp.asarray(ei)
    params = _np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jei,
                              *jextra, **kw))
    conv = load_jax_params(make_port(), params)

    def f(p, jx, *jext):
        return jm.apply(p, jx, jei, *jext, **kw)

    shapes = jax.eval_shape(f, params, jnp.asarray(x), *jextra)
    grng = np.random.default_rng(3)
    g = jax.tree_util.tree_map(
        lambda s: grng.normal(size=s.shape).astype(np.float32), shapes)
    floating = [i for i, a in enumerate(jextra)
                if jnp.issubdtype(a.dtype, jnp.floating)]
    want, grads = _jax_out_and_grads(
        f, lambda out: _loss(out, jax.tree_util.tree_map(jnp.asarray, g)),
        params, jnp.asarray(x), *jextra,
        argnums=(0, 1) + tuple(2 + i for i in floating))
    tx = torch.tensor(x, requires_grad=True)
    got = conv(tx, torch.tensor(ei), *textra, **tkw)
    tg = jax.tree_util.tree_map(torch.tensor, g)
    if isinstance(want, tuple):
        for a, b in zip(got, want):
            _check(a, b, 1e-5)
    else:
        _check(got, want, 1e-5)
    _loss(got, tg).backward()
    _check_grads(conv, grads[0], 1e-5)
    _check(tx.grad, grads[1], 1e-5)
    for i, jg in zip(floating, grads[2:]):
        if jg.size:
            _check(textra[i].grad, jg, 1e-5)
        else:  # E == 0: no pseudo-coordinates
            assert textra[i].grad is None or textra[i].grad.numel() == 0


def test_isolated_and_padded_rows():
    """The rows that receive no edge are the JAX function of their own
    row alone (EdgeConv's, a max over nothing, are 0); a padded edge adds
    nothing: the same graph without its pads gives the same output."""
    ei, n = _graph("pad")
    x = np.random.default_rng(4).normal(size=(n, F_IN)).astype(np.float32)
    jm = jconv.EdgeConv(F_OUT)
    params = _np_tree(jm.init(jax.random.PRNGKey(5), jnp.asarray(x),
                              jnp.asarray(ei)))
    conv = load_jax_params(tconv.EdgeConv(F_IN, F_OUT), params)
    with torch.no_grad():
        got = conv(torch.tensor(x), torch.tensor(ei))
        unpadded = conv(torch.tensor(x), torch.tensor(ei[:, :-6]))
    assert (got[-5:] == 0).all() and got[:-5].abs().sum() > 0
    torch.testing.assert_close(got, unpadded, rtol=0, atol=0)


def test_c21_bf16_counts_do_not_saturate_unlike_the_reference():
    """ROADMAP C21: the JAX PNAConv and HypergraphConv count degrees in
    x's dtype, which in bfloat16 stops at 256; the port counts in float32
    (as C1) and casts once. At a row of 300 in-edges, bfloat16 ones: PNA's
    max, amplified by log(deg + 1), is log(257) in JAX and log(301) in the
    port; a hyperedge of 301 members takes their sum (301 in both) over
    256 in JAX and over 301 in the port. Both packages give one dtype
    (float32: each map promotes bfloat16 x with float32 weights)."""
    n = 301
    ei = np.stack([np.arange(1, n), np.zeros(n - 1, np.int64)])
    ones = np.ones((n, 1), np.float32)
    jx, tx = jnp.asarray(ones, jnp.bfloat16), torch.tensor(
        ones, dtype=torch.bfloat16)
    params = {"params": {"Dense_0": {
        "kernel": np.asarray([[0.0], [1.0]], np.float32),
        "bias": np.zeros(1, np.float32)}}}
    kw = {"aggregators": ("max",), "scalers": ("amplification",)}
    want = jconv.PNAConv(1, **kw).apply(params, jx, jnp.asarray(ei))
    conv = load_jax_params(tconv.PNAConv(1, 1, **kw), params)
    with torch.no_grad():
        got = conv(tx, torch.tensor(ei))
    assert str(want.dtype) == str(got.dtype).split(".")[1]
    assert float(want[0, 0]) == pytest.approx(np.log(257), rel=1e-2)
    assert float(got[0, 0]) == pytest.approx(np.log(301), rel=1e-2)
    he = np.stack([np.arange(n), np.zeros(n, np.int64)])
    hparams = {"params": {"Dense_0": {"kernel": np.ones((1, 1),
                                                        np.float32)}}}
    jout = jconv.HypergraphConv(1).apply(hparams, jx, jnp.asarray(he),
                                         num_edges=1)
    hconv = load_jax_params(tconv.HypergraphConv(1, 1), hparams)
    with torch.no_grad():
        tout = hconv(tx, torch.tensor(he), num_edges=1)
    assert str(jout.dtype) == str(tout.dtype).split(".")[1]
    np.testing.assert_allclose(np.asarray(jout, np.float32), 301 / 256,
                               rtol=1e-2)
    np.testing.assert_allclose(tout.float().numpy(), 1.0, rtol=1e-2)
    # in float32 the two packages agree
    with torch.no_grad():
        f32 = hconv(torch.tensor(ones), torch.tensor(he), num_edges=1)
    np.testing.assert_allclose(
        f32.numpy(), np.asarray(jconv.HypergraphConv(1).apply(
            hparams, jnp.asarray(ones), jnp.asarray(he), num_edges=1)),
        rtol=1e-6)


def test_c22_hypergraph_ignores_attention_and_heads():
    """ROADMAP C22: HypergraphConv accepts ``use_attention`` and ``heads``
    and ignores them, in both packages: its tree is ``Dense_0`` alone and
    its output is that of the plain conv."""
    ei, n = _graph("pad")
    x = np.random.default_rng(6).normal(size=(n, F_IN)).astype(np.float32)
    jm = jconv.HypergraphConv(F_OUT, use_attention=True, heads=2)
    params = _np_tree(jm.init(jax.random.PRNGKey(7), jnp.asarray(x),
                              jnp.asarray(ei), num_edges=n))
    assert list(params["params"]) == ["Dense_0"]
    att = tconv.HypergraphConv(F_IN, F_OUT, use_attention=True, heads=2)
    assert list(att.flax_tree()) == ["Dense_0"]
    load_jax_params(att, params)
    plain = load_jax_params(tconv.HypergraphConv(F_IN, F_OUT), params)
    want = jconv.HypergraphConv(F_OUT).apply(params, jnp.asarray(x),
                                             jnp.asarray(ei), num_edges=n)
    with torch.no_grad():
        got = att(torch.tensor(x), torch.tensor(ei), num_edges=n)
        torch.testing.assert_close(
            got, plain(torch.tensor(x), torch.tensor(ei), num_edges=n),
            rtol=0, atol=0)
    _check(got, jm.apply(params, jnp.asarray(x), jnp.asarray(ei),
                         num_edges=n), 1e-5)
    _check(got, want, 1e-5)
