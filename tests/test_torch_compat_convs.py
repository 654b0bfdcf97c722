"""The port's compat convs (`layers/conv/compat_convs.py`: FusedGATConv,
MAGCLConv, MGNNI_m_iter) against the JAX package's.

FusedGATConv is held bitwise against the port's own GATConv on the same
plan (its route is GATConv's plan route: the flash kernels on the card,
their plain versions here), and against the JAX FusedGATConv, whose
Pallas kernels run in interpret mode (the output at 1e-5 of max |out|,
the gradients at 1e-4: the JAX kernels take bf16x3 products, as
`tests/test_torch_gat.py` records), and against the JAX COO GATConv at
1e-5. MAGCLConv in its four norms and
MGNNI_m_iter: outputs and gradients at 1e-5. One JAX compile a case,
cached for the module.
"""

import functools
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
from gammagl_tpu.layers.conv import FusedGATConv as JaxFusedGATConv  # noqa
from gammagl_tpu.layers.conv import GATConv as JaxGATConv  # noqa: E402
from gammagl_tpu.layers.conv import MAGCLConv as JaxMAGCLConv  # noqa: E402
from gammagl_tpu.layers.conv import MGNNI_m_iter as JaxMGNNI  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

from gammagl_tpu_torch.layers.conv import (FusedGATConv, GATConv,  # noqa
                                           MAGCLConv, MGNNI_m_iter)
from gammagl_tpu_torch.ops.cuda import CSRPlan  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

TOL = 1e-5
N, E, FEAT = 40, 150, 10
KEY = jax.random.PRNGKey(9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph(seed=0):
    """Self-loops on every node; nodes N-5.. receive nothing else."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N - 5, E)])
    ei, _ = jax_add_self_loops(ei, num_nodes=N)
    return x, np.asarray(ei, np.int64)


X, EI = _graph()
W = (np.random.default_rng(4).random(EI.shape[1]) * 0.9 + 0.1).astype(
    np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _gat_params(heads, F, concat=True, seed=2):
    rng = np.random.default_rng(seed)
    return {"params": {
        "w": (rng.normal(size=(FEAT, heads * F)) * 0.4).astype(np.float32),
        "att": (rng.normal(size=(1, heads, 2 * F)) * 0.4).astype(np.float32),
        "bias": (rng.normal(size=(heads * F if concat else F,)) * 0.1
                 ).astype(np.float32)}}


GAT_SHAPES = [(2, 6, True), (1, 5, False), (3, 4, False)]


@functools.lru_cache(maxsize=None)
def _jax_fused(heads, F, concat):
    """JAX's FusedGATConv (Pallas, interpret mode on the CPU) and its COO
    GATConv on the same parameters: outputs and the gradients of
    sum(out * g) in the parameters."""
    params = _gat_params(heads, F, concat)
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    plan = JaxFusedGATConv.to_graph_format(EI, N, R=8, ET=16)
    g = _cot((N, heads * F if concat else F))
    out = {}
    for name, conv, kw in (
            ("fused", JaxFusedGATConv(F, heads=heads, concat=concat),
             {"plan": plan}),
            ("coo", JaxGATConv(F, heads=heads, concat=concat), {})):
        def loss(p, conv=conv, kw=kw):
            o = conv.apply(p, x, ei, **kw)
            return jnp.sum(o * g), o
        grads, o = jax.jit(jax.grad(loss, has_aux=True))(params)
        out[name] = (np.asarray(o), grads)
    return params, g, out


@pytest.mark.parametrize("heads,F,concat", GAT_SHAPES)
def test_fused_gat_matches_gatconv_on_the_plan_bitwise(heads, F, concat):
    params = _gat_params(heads, F, concat)
    plan = FusedGATConv.to_graph_format(_t(EI), N)
    assert isinstance(plan, CSRPlan)
    g = _t(_cot((N, heads * F if concat else F)))
    results = []
    for cls in (FusedGATConv, GATConv):
        conv = load_jax_params(cls(None, F, heads=heads, concat=concat),
                               params)
        x = _t(X).requires_grad_()
        out = conv(x, _t(EI), plan=plan)
        (out * g).sum().backward()
        results.append([out.detach(), x.grad] + [
            p.grad for p in (conv.w, conv.att, conv.bias)])
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("heads,F,concat", GAT_SHAPES)
def test_fused_gat_matches_jax(heads, F, concat):
    params, g, want = _jax_fused(heads, F, concat)
    conv = load_jax_params(FusedGATConv(None, F, heads=heads,
                                        concat=concat), params)
    # the TPU tiling keywords of the JAX builder are accepted and ignored
    plan = FusedGATConv.to_graph_format(EI, N, R=8, ET=16, window=False)
    out = conv(_t(X), _t(EI), plan=plan)
    (out * _t(g)).sum().backward()
    _check(out, want["fused"][0], TOL)
    _check(out, want["coo"][0], TOL)
    _check_grads(conv, want["fused"][1], 1e-4)
    _check_grads(conv, want["coo"][1], TOL)


def test_fused_gat_raises_without_a_plan():
    conv = FusedGATConv(FEAT, 4, heads=2)
    with pytest.raises(ValueError, match="to_graph_format"):
        conv(_t(X), _t(EI))
    jconv = JaxFusedGATConv(4, heads=2)
    with pytest.raises(ValueError, match="to_graph_format"):
        jconv.init(KEY, jnp.asarray(X), jnp.asarray(EI))


def test_fused_gat_plan_default_size_and_dropout_keep():
    """``num_nodes`` defaults to the largest id + 1; in training mode a
    caller's ``keep`` mask gives GATConv's output on the same plan."""
    plan = FusedGATConv.to_graph_format(EI)
    assert plan.num_nodes == N
    params = _gat_params(2, 6)
    keep = _t(np.random.default_rng(3).random((EI.shape[1], 2)) > 0.4)
    outs = []
    for cls in (FusedGATConv, GATConv):
        conv = load_jax_params(cls(None, 6, heads=2, dropout_rate=0.4),
                               params).train()
        outs.append(conv(_t(X), _t(EI), plan=plan, keep=keep))
    assert torch.equal(*outs)


MAGCL = [(norm, k, weighted) for norm in ("both", "left", "right", "none")
         for k, weighted in ((2, False), (3, True))] + [("both", 0, False),
                                                       ("none", 1, False)]


@functools.lru_cache(maxsize=None)
def _jax_magcl(norm, k, weighted, bias=True):
    conv = JaxMAGCLConv(7, norm=norm, add_bias=bias)
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    w = jnp.asarray(W) if weighted else None
    params = jax.jit(lambda: conv.init(KEY, x, ei, k, w))()
    if bias:  # a nonzero bias, so its gradient path is exercised
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["params"]["bias"] = jnp.asarray(_cot((7,), 5))
    g = _cot((N, 7))

    def loss(p):
        o = conv.apply(p, x, ei, k, w)
        return jnp.sum(o * g), o

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return _np_tree(params), np.asarray(out), grads, g


@pytest.mark.parametrize("norm,k,weighted", MAGCL)
def test_magcl_conv_matches_jax(norm, k, weighted):
    params, want, grads, g = _jax_magcl(norm, k, weighted)
    conv = load_jax_params(MAGCLConv(None, 7, norm=norm), params)
    out = conv(_t(X), _t(EI), k, _t(W) if weighted else None)
    (out * _t(g)).sum().backward()
    _check(out, want, TOL)
    _check_grads(conv, grads, TOL)


def test_magcl_conv_no_bias_and_init_law():
    """Without a bias the tree holds the weight alone; the port's own
    weight is truncated_normal(0.02), as flax's."""
    params, want, _, _ = _jax_magcl("both", 2, False, bias=False)
    assert set(params["params"]) == {"weight"}
    conv = load_jax_params(MAGCLConv(None, 7, add_bias=False), params)
    _check(conv(_t(X), _t(EI)), want, TOL)
    torch.manual_seed(0)
    w = MAGCLConv(400, 50).weight.detach()
    assert float(w.abs().max()) <= 0.04 + 1e-7
    assert abs(float(w.std()) - 0.02 * 0.8796) < 1e-3
    with pytest.raises(ValueError):
        MAGCLConv(4, 4, norm="sym")


@functools.lru_cache(maxsize=None)
def _jax_mgnni(k, weighted):
    conv = JaxMGNNI(FEAT, k=k, gamma=0.7, max_iter=6)
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    w = jnp.asarray(W * 0.5) if weighted else None
    params = {"params": {"F": jnp.asarray(_cot((FEAT, FEAT), 8) * 0.5)}}
    g = _cot((N, FEAT), 9)

    def loss(p, xx):
        o = conv.apply(p, xx, ei, w)
        return jnp.sum(o * g), o

    (gp, gx), out = jax.jit(jax.grad(loss, argnums=(0, 1),
                                     has_aux=True))(params, x)
    return _np_tree(params), np.asarray(out), gp, np.asarray(gx), g


@pytest.mark.parametrize("k,weighted", [(1, False), (2, True)])
def test_mgnni_m_iter_matches_jax(k, weighted):
    params, want, grads, gx, g = _jax_mgnni(k, weighted)
    conv = load_jax_params(MGNNI_m_iter(FEAT, k=k, gamma=0.7, max_iter=6),
                           params)
    x = _t(X).requires_grad_()
    out = conv(x, _t(EI), _t(W * 0.5) if weighted else None)
    (out * _t(g)).sum().backward()
    _check(out, want, TOL)
    _check(x.grad, gx, TOL)
    _check_grads(conv, grads, TOL)


def test_mgnni_m_iter_at_its_zero_init_differs_on_purpose():
    """ROADMAP C36. F starts at zeros in both packages, so F^T F = 0 and
    its Frobenius norm is taken at 0: JAX's norm gradient there is NaN,
    and so is JAX's dF; the port's `torch.linalg.norm` gives 0 there, and
    dF = 0, which is the exact derivative of F^T F at F = 0 (F stays at
    zero under any gradient step in exact arithmetic). The outputs agree:
    Z = x + gamma * (A Z) 0 = x."""
    conv = JaxMGNNI(FEAT, max_iter=3)
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    params = conv.init(KEY, x, ei)
    jout = conv.apply(params, x, ei)
    jgrad = jax.grad(lambda p: conv.apply(p, x, ei).sum())(params)
    assert np.isnan(np.asarray(jgrad["params"]["F"])).all()
    port = MGNNI_m_iter(FEAT, max_iter=3)
    out = port(_t(X), _t(EI))
    out.sum().backward()
    _check(out, jout, TOL)
    assert torch.equal(port.F.grad, torch.zeros(FEAT, FEAT))
