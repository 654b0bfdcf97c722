"""The port's segment max and min (`gammagl_tpu_torch.ops.cuda.segment_max`)
against the JAX package: its Pallas kernel in interpret mode
(`gammagl_tpu.ops.pallas.segment_max`), on plans built with
``window=False`` and ``window=True``, and XLA's ``segment_max`` /
``segment_min`` over the same messages.

On the CPU the port runs its plain version. Per-edge tensors are mapped to
the caller's edge order on both sides; layouts are never compared.
Tolerances: the forward is bitwise (a max is exact in any order, in f32
and bf16, with or without weights); gradients within 1e-5 of max |grad|
against ``jax.grad``, ties split evenly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu import ops as jops
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import segment_max as jsm

from gammagl_tpu_torch import ops as tops
from gammagl_tpu_torch.layers.conv import MessagePassing
from gammagl_tpu_torch.ops import cuda as k
from gammagl_tpu_torch.ops import spmm

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
FNS = {"max": (k.spmm_max_csr, jsm.spmm_max_csr, jops.segment_max),
       "min": (k.spmm_min_csr, jsm.spmm_min_csr, jops.segment_min)}
PER_EDGE = {"max": (k.segment_max_csr, jsm.segment_max_csr, jops.segment_max),
            "min": (k.segment_min_csr, jsm.segment_min_csr,
                    jops.segment_min)}


def _case(seed=0, n_src=40, n_dst=30, e=260, F=6):
    """A bipartite graph whose last 6 destination rows get no edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst - 6, e)
    x = rng.normal(size=(n_src, F)).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32)
    return src, dst, x, w


def _plans(src, dst, n_dst, n_src, window):
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src, R=8, ET=16,
                               window=window)
    tplan = k.build_csr_plan(src, dst, n_dst, num_src=n_src, window=window)
    return jplan, tplan


def _pad_order(jplan, vals):
    """Caller-order values -> the JAX plan's padded lane order (pads 0)."""
    ext = np.concatenate([vals, np.zeros((1,) + vals.shape[1:], vals.dtype)])
    return ext[np.minimum(jplan.perm, jplan.num_edges)]


def _from_pad(jplan, vals):
    """The JAX plan's padded lane order -> the caller's order."""
    out = np.zeros((jplan.num_edges,) + vals.shape[1:], np.float32)
    valid = np.asarray(jplan.valid)
    out[np.asarray(jplan.perm)[valid]] = vals[valid]
    return out


def _from_csr(tplan, vals):
    out = np.zeros((tplan.num_edges,) + tuple(vals.shape[1:]), np.float32)
    out[tplan.perm] = vals.float().detach().numpy()
    return out


def _bits_equal(got, want):
    got = got.float().detach().numpy()
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _messages(x, w, src, jdt):
    """The JAX module's messages: x[src] times w rounded to x's dtype."""
    msg = jnp.asarray(x, jdt)[jnp.asarray(src)]
    if w is not None:
        msg = msg * jnp.asarray(w).astype(jdt)[:, None]
    return msg


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_spmm_max_min_is_bitwise_equal_to_jax(op, dtype, weighted, window):
    src, dst, x, w = _case(F=7 if dtype == "f32" else 16)
    w = w if weighted else None
    jdt, tdt = DTYPES[dtype]
    jplan, tplan = _plans(src, dst, 30, 40, window)
    port, pallas, xla = FNS[op]
    got = port(torch.tensor(x).to(tdt),
               None if w is None else torch.tensor(w), tplan)
    assert got.dtype == tdt and got.shape == (30, x.shape[1])
    want = pallas(jnp.asarray(x, jdt), None if w is None else jnp.asarray(w),
                  jplan, interpret=True)
    _bits_equal(got, want)
    _bits_equal(got, xla(_messages(x, w, src, jdt), jnp.asarray(dst), 30))
    assert bool((got[24:] == 0).all())


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_max_min_csr_is_bitwise_equal_to_jax(op, dtype, window):
    """Per-edge rows: the port's in CSR order, the JAX kernel's in its
    padded lane order."""
    src, dst, _, _ = _case(1)
    jdt, tdt = DTYPES[dtype]
    msg = np.random.default_rng(2).normal(size=(len(src), 9)).astype(
        np.float32)
    jplan, tplan = _plans(src, dst, 30, 40, window)
    port, pallas, xla = PER_EDGE[op]
    got = port(torch.tensor(msg).to(tdt)[torch.from_numpy(tplan.perm)], tplan)
    if not window:  # the JAX per-edge entry reads the padded layout
        want = pallas(jnp.asarray(_pad_order(jplan, msg), jdt), jplan,
                      interpret=True)
        _bits_equal(got, want)
    _bits_equal(got, xla(jnp.asarray(msg, jdt), jnp.asarray(dst), 30))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_no_edges_and_empty_rows_give_zero(dtype):
    jdt, tdt = DTYPES[dtype]
    none = np.zeros(0, np.int64)
    jplan, tplan = _plans(none, none, 12, 5, False)
    x = np.random.default_rng(3).normal(size=(5, 4)).astype(np.float32) - 5
    for op in ("max", "min"):
        port, pallas, _ = FNS[op]
        got = port(torch.tensor(x).to(tdt), None, tplan)
        _bits_equal(got, pallas(jnp.asarray(x, jdt), None, jplan,
                                interpret=True))
        assert got.shape == (12, 4) and bool((got == 0).all())
    # negative messages keep their (negative) maxima; rows past them are 0
    src = dst = np.arange(3)
    jplan, tplan = _plans(src, dst, 12, 5, True)
    got = k.spmm_max_csr(torch.tensor(x).to(tdt), None, tplan)
    _bits_equal(got[:3], torch.tensor(x[:3]).to(tdt))
    assert bool((got[3:] == 0).all())


def test_ties_forward_and_gradient_split_evenly():
    """Row 0's edges all carry the same row; row 1 has two tied edges in
    column 0 only. The forward is that value; the cotangent is split evenly
    among the winners, as jax.grad of the Pallas kernel splits it."""
    x = np.array([[1.5, -2.0, 0.25], [1.5, -2.0, 0.25], [1.5, -2.0, 0.25],
                  [3.0, 1.0, -1.0], [3.0, 0.5, 2.0]], np.float32)
    src = np.array([0, 1, 2, 3, 4])
    dst = np.array([0, 0, 0, 1, 1])
    g = np.array([[3.0, 6.0, 9.0], [4.0, 5.0, 7.0]], np.float32)
    jplan, tplan = _plans(src, dst, 2, 5, True)
    tx = torch.tensor(x, requires_grad=True)
    out = k.spmm_max_csr(tx, None, tplan)
    _bits_equal(out, np.array([[1.5, -2.0, 0.25], [3.0, 1.0, 2.0]]))
    (out * torch.tensor(g)).sum().backward()
    want = jax.grad(lambda a: jnp.sum(jsm.spmm_max_csr(
        a, None, jplan, interpret=True) * g))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy()[:3], [[1.0, 2.0, 3.0]] * 3)
    np.testing.assert_allclose(tx.grad.numpy()[3:],
                               [[2.0, 5.0, 0.0], [2.0, 0.0, 7.0]])


def _loss_grads(port_out, gout):
    (port_out.float() * torch.tensor(gout)).sum().backward()


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
def test_gradients_match_jax_grad(op, weighted, window):
    """dx and dw of sum(out * g) against jax.grad of the Pallas path, f32;
    integer-valued features make many ties."""
    src, dst, x, w = _case(4)
    x = np.round(x * 2).astype(np.float32)
    w = np.round(w * 2).astype(np.float32) if weighted else None
    jplan, tplan = _plans(src, dst, 30, 40, window)
    port, pallas, _ = FNS[op]
    gout = np.random.default_rng(5).normal(size=(30, x.shape[1])).astype(
        np.float32)

    def loss(a, b):
        return jnp.sum(pallas(a, b, jplan, interpret=True) * gout)

    args = (jnp.asarray(x), None if w is None else jnp.asarray(w))
    want = jax.grad(loss, argnums=(0, 1) if weighted else 0)(*args)
    want_dx, want_dw = want if weighted else (want, None)
    tx = torch.tensor(x, requires_grad=True)
    tw = None if w is None else torch.tensor(w, requires_grad=True)
    _loss_grads(port(tx, tw, tplan), gout)
    for got, ref in ((tx.grad, want_dx), (None if tw is None else tw.grad,
                                          want_dw)):
        if ref is None:
            continue
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("op", ["max", "min"])
def test_per_edge_gradient_matches_jax_grad(op):
    src, dst, _, _ = _case(6)
    msg = np.round(np.random.default_rng(7).normal(size=(len(src), 5)) * 2
                   ).astype(np.float32)
    jplan, tplan = _plans(src, dst, 30, 40, False)
    port, pallas, _ = PER_EDGE[op]
    gout = np.random.default_rng(8).normal(size=(30, 5)).astype(np.float32)
    want = jax.grad(lambda m: jnp.sum(pallas(m, jplan, interpret=True)
                                      * gout))(
        jnp.asarray(_pad_order(jplan, msg)))
    perm = torch.from_numpy(tplan.perm)
    tm = torch.tensor(msg)[perm].requires_grad_()
    _loss_grads(port(tm, tplan), gout)
    ref = _from_pad(jplan, np.asarray(want))
    np.testing.assert_allclose(_from_csr(tplan, tm.grad), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_create_graph_raises():
    src, dst, x, w = _case(9)
    plan = k.build_csr_plan(src, dst, 30, num_src=40)
    tx = torch.tensor(x, requires_grad=True)
    out = k.spmm_max_csr(tx, None, plan).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(out, tx, create_graph=True)


def test_reference_counts_no_launch_and_checks_shapes():
    src, dst, x, _ = _case(10)
    plan = k.build_csr_plan(src, dst, 30, num_src=40)
    before = (k.spmm_max_csr.launches, k.segment_max_bwd.launches)
    tx = torch.tensor(x, requires_grad=True)
    k.spmm_max_csr(tx, None, plan).sum().backward()
    assert (k.spmm_max_csr.launches, k.segment_max_bwd.launches) == before
    with pytest.raises(ValueError, match="msg must be"):
        k.segment_max_csr(torch.ones(3, 2), plan)
    with pytest.raises(ValueError, match="rows"):
        k.spmm_max_csr(torch.ones(3, 2), None, plan)


@pytest.mark.parametrize("weighted", [False, True])
def test_message_passing_max_with_a_plan_takes_the_kernel(weighted):
    """The port's `message_aggregate(aggr='max', plan=...)` runs
    `spmm_max_csr` (it raised before), equal to the COO path."""
    src, dst, x, w = _case(11)
    ei = torch.tensor(np.stack([src, dst]))
    tw = torch.tensor(w) if weighted else None
    plan = k.build_csr_plan(src, dst, 30, num_src=40)
    mp = MessagePassing()
    tx = torch.tensor(x)
    got = mp.message_aggregate(tx, ei, tw, aggr="max", num_nodes=30,
                               plan=plan)
    want = spmm(ei, tw, tx, num_nodes=30, reduce="max")
    _bits_equal(got, want)


@pytest.mark.parametrize("window", [None, False, True])
def test_plan_keeps_window(window):
    src, dst, _, _ = _case(12)
    plan = k.build_csr_plan(src, dst, 30, num_src=40, window=window)
    assert plan.window is bool(window)
    other = k.build_csr_plan(src, dst, 30, num_src=40)
    for name in ("rowptr", "col", "perm"):  # no layout changes
        np.testing.assert_array_equal(getattr(plan, name),
                                      getattr(other, name))


def _equal_with_inf(got, want):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_infinite_winners_give_zero_as_jax(dtype):
    """A winner of -inf (+inf for the min) gives 0 in the plain CSR
    versions, as the JAX kernel's and XLA's ``where`` (ROADMAP C7); the
    other infinity stays; its gradient is 0."""
    jdt, tdt = DTYPES[dtype]
    src, dst, x, _ = _case(13)
    x[:, 0], x[:, 1] = -np.inf, np.inf
    jplan, tplan = _plans(src, dst, 30, 40, False)
    for op in ("max", "min"):
        port, pallas, xla = FNS[op]
        tx = torch.tensor(x).to(tdt).requires_grad_()
        got = port(tx, None, tplan)
        want = np.asarray(pallas(jnp.asarray(x, jdt), None, jplan,
                                 interpret=True), np.float32)
        # the Pallas bf16 pick is a one-hot matmul, whose 0 * inf gives NaN
        # in the infinite columns: there the port is held to XLA alone
        cols = slice(2, None) if dtype == "bf16" else slice(None)
        _equal_with_inf(got[:, cols], want[:, cols])
        _equal_with_inf(got, xla(_messages(x, None, src, jdt),
                                 jnp.asarray(dst), 30))
        col = 0 if op == "max" else 1
        assert bool((got[:, col] == 0).all())
        got[:, col].float().sum().backward()
        assert bool((tx.grad == 0).all())


@pytest.mark.parametrize("op", ["max", "min"])
def test_segment_reductions_of_infinite_segments_match_jax(op):
    """ops.segment_max / segment_min and the per-edge CSR form on
    segments whose every entry is -inf (+inf for the min)."""
    inf = -np.inf if op == "max" else np.inf
    data = np.random.default_rng(14).normal(size=(7, 3)).astype(np.float32)
    data[:3] = inf           # segment 0: all infinite
    data[5, 1] = inf         # segment 2: one infinite entry among others
    ids = np.array([0, 0, 0, 2, 2, 2, 3])
    tfn = tops.segment_max if op == "max" else tops.segment_min
    jfn = jops.segment_max if op == "max" else jops.segment_min
    got = tfn(torch.from_numpy(data), torch.from_numpy(ids), 5)
    _equal_with_inf(got, jfn(jnp.asarray(data), jnp.asarray(ids), 5))
    assert bool((got[0] == 0).all()) and bool((got[1] == 0).all())
    plan = k.build_csr_plan(np.zeros(7, np.int64), ids, 5, num_src=1)
    per_edge = k.segment_max_csr if op == "max" else k.segment_min_csr
    msg = torch.from_numpy(data)[torch.from_numpy(plan.perm)]
    torch.testing.assert_close(per_edge(msg, plan), got, rtol=0, atol=0)


def test_softmax_of_masked_segments_gives_zero_as_jax():
    """Scores [-inf, -inf | 1, 2] over two segments: [0, 0, 0.2689,
    0.7311], not NaN (ROADMAP C7)."""
    scores = np.array([-np.inf, -np.inf, 1.0, 2.0], np.float32)
    ids = np.array([0, 0, 1, 1])
    got = tops.segment_softmax(torch.from_numpy(scores),
                               torch.from_numpy(ids), 2)
    want = np.asarray(jops.segment_softmax(jnp.asarray(scores),
                                           jnp.asarray(ids), 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.numpy(), [0, 0, 0.26894142, 0.73105858],
                               rtol=1e-6)
    heads = torch.from_numpy(np.stack([scores, scores[::-1].copy()], 1))
    assert not bool(torch.isnan(tops.segment_softmax(
        heads, torch.from_numpy(ids), 2)).any())


@pytest.mark.parametrize("kind", ["csr", "block_pair", "hybrid"])
def test_message_passing_min_with_any_plan_takes_the_coo_path(kind):
    """`message_aggregate(aggr='min', plan=...)` runs the COO spmm with
    every plan kind, as the JAX layer does (it raised before: ROADMAP
    C8)."""
    from gammagl_tpu.layers.conv import MessagePassing as JaxMP
    from gammagl_tpu.ops.pallas import (build_block_pair_plan as jbp,
                                        build_hybrid_plan as jhy)
    rng = np.random.default_rng(15)
    n, e = 128, 900
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-8, 9, e), 0, n - 1)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32)
    build = {"csr": (k.build_csr_plan, jax_build_csr_plan),
             "block_pair": (k.build_block_pair_plan, jbp),
             "hybrid": (k.build_hybrid_plan, jhy)}[kind]
    kw = {} if kind == "csr" else {"R": 32, "S": 32, "ET": 64}
    plan, jplan = (b(src, dst, n, **kw) for b in build)
    ei = np.stack([src, dst])
    got = MessagePassing().message_aggregate(
        torch.from_numpy(x), torch.from_numpy(ei), torch.from_numpy(w),
        aggr="min", num_nodes=n, plan=plan)
    want = JaxMP().message_aggregate(jnp.asarray(x), jnp.asarray(ei),
                                     jnp.asarray(w), aggr="min",
                                     num_nodes=n, plan=jplan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(got, spmm(torch.from_numpy(ei),
                                         torch.from_numpy(w),
                                         torch.from_numpy(x), num_nodes=n,
                                         reduce="min"))
