"""The port's small shared surface against the JAX package: the
`unsorted_segment_*` aliases, `ops.sparse`, `sparse.SparseGraph` /
`CSRAdj`, `remove_self_loops` / `contains_self_loops`, `calc_gcn_norm`,
`micro_f1` / `macro_f1`, and the attention primitives
`segment_softmax_padded` and `bspmm_csr`.

The same seeded numpy inputs go through both packages. Host (numpy) code
is held bit for bit. Tensor ops: f32 at 1e-5 against XLA and 1e-4 against
the Pallas path in interpret mode (bf16x3 products that drop the lo*lo
term). The attention primitives run on JAX plans of the same edges, whose
per-edge tensors are in the plan's padded lane order; every per-edge
tensor is mapped to the caller's edge order before it is compared, and
cotangents are drawn in the caller's order and mapped into each layout.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import gammagl_tpu.ops as jax_ops
import gammagl_tpu.ops.sparse as jax_sparse
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import bspmm_csr as jax_bspmm_csr
from gammagl_tpu.ops.pallas import (segment_softmax_padded as
                                    jax_softmax_padded)
from gammagl_tpu.sparse import CSRAdj as JaxCSRAdj
from gammagl_tpu.sparse import SparseGraph as JaxSparseGraph
from gammagl_tpu.train import macro_f1 as jax_macro_f1
from gammagl_tpu.train import micro_f1 as jax_micro_f1
from gammagl_tpu.utils import calc_gcn_norm as jax_calc_gcn_norm
from gammagl_tpu.utils import contains_self_loops as jax_contains
from gammagl_tpu.utils import remove_self_loops as jax_remove

import gammagl_tpu_torch.ops as ops
from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.sparse import CSRAdj, SparseGraph
from gammagl_tpu_torch.train import macro_f1, micro_f1
from gammagl_tpu_torch.utils import (calc_gcn_norm, contains_self_loops,
                                     remove_self_loops)


def _close(got, want, tol):
    """|got - want| <= tol * max |want|, elementwise."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("kind", ["sum", "mean", "max", "min"])
def test_unsorted_segment_aliases_match_jax(kind):
    rng = np.random.default_rng(0)
    data = rng.normal(size=(40, 3)).astype(np.float32)
    ids = rng.integers(0, 9, 40)  # unsorted, segment 9 of 10 empty
    port = getattr(ops, f"unsorted_segment_{kind}")
    assert port is getattr(ops, f"segment_{kind}")
    want = getattr(jax_ops, f"unsorted_segment_{kind}")(
        jnp.asarray(data), jnp.asarray(ids), 10)
    _close(port(torch.tensor(data), torch.tensor(ids), 10), want, 1e-6)


def test_sparse_conversions_match_jax():
    rng = np.random.default_rng(1)
    ind = np.sort(rng.integers(0, 12, 50))  # rows 12..14 and some below empty
    ptr = jax_sparse.ind2ptr_np(ind, 15)
    np.testing.assert_array_equal(ops.ind2ptr_np(ind, 15), ptr)
    assert ops.ind2ptr_np(ind, 15).dtype == np.int32
    np.testing.assert_array_equal(ops.ptr2ind_np(ptr),
                                  jax_sparse.ptr2ind_np(ptr))
    np.testing.assert_array_equal(ops.ptr2ind_np(ptr, 20),
                                  jax_sparse.ptr2ind_np(ptr, 20))
    got = ops.ind2ptr(torch.tensor(ind), 15)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sparse.ind2ptr(jnp.asarray(ind), 15)))
    got = ops.ptr2ind(torch.tensor(ptr), 50)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sparse.ptr2ind(jnp.asarray(ptr), 50)))
    for inverse, counts in ((False, False), (True, True)):
        want = jax_sparse.unique_np(ind, inverse, counts)
        got = ops.unique_np(ind, inverse, counts)
        for a, b in zip(got if inverse else [got], want if inverse
                        else [want]):
            np.testing.assert_array_equal(a, b)


def _coo(seed, m=20, n=15, e=90):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, m, e), rng.integers(0, n, e),
            rng.normal(size=e).astype(np.float32))


def test_sparse_graph_formats_match_jax():
    row, col, val = _coo(2)
    for sizes in (None, (25, 18)):
        g, jg = SparseGraph(row, col, val, sizes), JaxSparseGraph(
            row, col, val, sizes)
        assert g.sparse_sizes() == jg.sparse_sizes() and g.nnz == jg.nnz
        for got, want in ((g.coo(), jg.coo()), (g.csr(), jg.csr()),
                          (g.csc(), jg.csc()), (g.t().csr(), jg.t().csr())):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert g.csr() is g.csr()  # cached
    g = SparseGraph.from_edge_index(np.stack([row, col]))
    jg = JaxSparseGraph.from_edge_index(np.stack([row, col]))
    assert g.sparse_sizes() == jg.sparse_sizes() and g.coo()[2] is None
    empty = SparseGraph(np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert empty.sparse_sizes() == (0, 0) and empty.csr()[0].tolist() == [0]


@pytest.mark.parametrize("num_neighbors,replace", [(3, False), (3, True),
                                                   (-1, False), (50, False)])
def test_sample_adj_matches_jax_under_one_seed(num_neighbors, replace):
    row, col, _ = _coo(3, m=30, n=30, e=200)
    subset = np.array([4, 0, 17, 29, 11])
    got, n_id = SparseGraph(row, col).sample_adj(
        subset, num_neighbors, replace, rng=np.random.default_rng(7))
    want, jn_id = JaxSparseGraph(row, col).sample_adj(
        subset, num_neighbors, replace, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(n_id, jn_id)
    np.testing.assert_array_equal(n_id[:len(subset)], subset)
    assert got.sparse_sizes() == want.sparse_sizes()
    for a, b in zip(got.coo(), want.coo()):
        np.testing.assert_array_equal(a, b)
    # each sampled entry is a real edge into its destination
    r, c, eid = got.coo()
    np.testing.assert_array_equal(row[eid], n_id[r])
    np.testing.assert_array_equal(col[eid], subset[c])


def test_csr_adj_matches_jax():
    row, col, _ = _coo(4)
    for n in (None, 40):
        a, ja = CSRAdj.from_edges(row, col, n), JaxCSRAdj.from_edges(
            row, col, n)
        assert a.num_nodes == ja.num_nodes
        np.testing.assert_array_equal(a.rowptr, ja.rowptr)
        np.testing.assert_array_equal(a.col, ja.col)
        np.testing.assert_array_equal(a.degree(), ja.degree())


def test_self_loop_helpers_match_jax():
    rng = np.random.default_rng(5)
    ei = rng.integers(0, 6, (2, 40))
    attr = rng.normal(size=(40, 2)).astype(np.float32)
    want_ei, want_attr = jax_remove(ei, attr)
    for kind in (np.asarray, torch.tensor):
        got_ei, got_attr = remove_self_loops(kind(ei), kind(attr))
        assert isinstance(got_ei, type(kind(ei)))
        np.testing.assert_array_equal(np.asarray(got_ei), want_ei)
        np.testing.assert_array_equal(np.asarray(got_attr), want_attr)
        assert remove_self_loops(kind(ei))[1] is None
        assert contains_self_loops(kind(ei)) is jax_contains(ei) is True
        assert contains_self_loops(kind(want_ei)) is False
        assert jax_contains(want_ei) is False


@pytest.mark.parametrize("weighted", [False, True])
def test_calc_gcn_norm_matches_jax(weighted):
    rng = np.random.default_rng(6)
    n = 12
    ei = np.concatenate([rng.integers(0, n - 2, (2, 50)),
                         np.stack([np.arange(n), np.arange(n)])], 1)
    ei[1, :3] = n - 1  # a node whose in-degree is only 3 + its loop
    w = rng.uniform(0.5, 2, ei.shape[1]).astype(np.float32) if weighted \
        else None
    want = jax_calc_gcn_norm(jnp.asarray(ei), n,
                             None if w is None else jnp.asarray(w))
    got = calc_gcn_norm(torch.tensor(ei), n,
                        None if w is None else torch.tensor(w))
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    # the unweighted in-degree, as the host version
    _close(calc_gcn_norm(torch.tensor(ei), n + 3), jax_calc_gcn_norm(
        jnp.asarray(ei), n + 3), 1e-6)


def test_f1_scores_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(80, 5)).astype(np.float32)
    labels = rng.integers(0, 4, 80)  # class 4 never a label
    mask = rng.random(80) < 0.5
    tl, tlab = torch.tensor(logits), torch.tensor(labels)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    for m in (None, mask):
        want = jax_micro_f1(jl, jlab, None if m is None else jnp.asarray(m))
        got = micro_f1(tl, tlab, None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for c in (None, 4, 7):
        np.testing.assert_allclose(float(macro_f1(tl, tlab, c)),
                                   float(jax_macro_f1(jl, jlab, c)),
                                   rtol=1e-6)
    perfect = torch.nn.functional.one_hot(tlab, 5).float()
    assert float(macro_f1(perfect, tlab, 4)) == 1.0


class _Plans:
    """One graph's CSR plan in both packages and the maps between the
    caller's edge order, the port's CSR order and the JAX plan's padded
    lane order."""

    def __init__(self, seed, n_dst=30, n_src=45, e=260):
        rng = np.random.default_rng(seed)
        # odd destination rows and the top half get no edges
        self.dst = 2 * rng.integers(0, n_dst // 4, e)
        self.src = rng.integers(0, n_src, e)
        self.n_dst, self.n_src, self.E = n_dst, n_src, e
        self.jplan = jax_build_csr_plan(self.src, self.dst, n_dst,
                                        num_src=n_src, R=8, ET=32)
        self.plan = kops.build_csr_plan(self.src, self.dst, n_dst,
                                        num_src=n_src)

    def to_lanes(self, vc):
        valid = self.jplan.valid
        out = np.zeros((len(valid),) + vc.shape[1:], np.float32)
        out[valid] = vc[self.jplan.perm[valid]]
        return jnp.asarray(out)

    def from_lanes(self, v):
        v = np.asarray(v, np.float32)
        out = np.zeros((self.E,) + v.shape[1:], np.float32)
        valid = self.jplan.valid
        out[self.jplan.perm[valid]] = v[valid]
        return out

    def to_csr(self, vc):
        return torch.tensor(np.asarray(vc, np.float32)[self.plan.perm])

    def from_csr(self, v):
        out = np.zeros(v.shape, np.float32)
        out[self.plan.perm] = v.detach().float().numpy()
        return out


@pytest.mark.parametrize("shape", [(), (4,)])
def test_segment_softmax_padded_matches_jax(shape):
    """Forward and the gradient of a weighted sum, (E,) and (E, H) scores,
    with one destination row whose every score is -inf (0, not NaN) and
    rows without edges."""
    p = _Plans(10)
    rng = np.random.default_rng(11)
    s = (rng.normal(size=(p.E,) + shape) * 3).astype(np.float32)
    s[p.dst == 4] = -np.inf
    g = rng.normal(size=s.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_softmax_padded(v, p.jplan),
                        p.to_lanes(s))
    (want_ds,) = vjp(p.to_lanes(g))
    ts = p.to_csr(s).requires_grad_()
    got = kops.segment_softmax_padded(ts, p.plan)
    assert got.dtype == torch.float32 and got.shape == ts.shape
    (got * p.to_csr(g)).sum().backward()
    _close(p.from_csr(got), p.from_lanes(want), 1e-5)
    assert (p.from_csr(got)[p.dst == 4] == 0).all()
    _close(p.from_csr(ts.grad), p.from_lanes(want_ds), 1e-5)


def test_segment_softmax_padded_keeps_the_dtype_and_checks_rows():
    p = _Plans(12)
    s = torch.randn(p.E, 2, generator=torch.Generator().manual_seed(0))
    got = kops.segment_softmax_padded(s.to(torch.bfloat16), p.plan)
    assert got.dtype == torch.bfloat16
    _close(got, kops.segment_softmax_padded(s, p.plan).numpy(), 1e-2)
    with pytest.raises(ValueError, match="edges"):
        kops.segment_softmax_padded(s[1:], p.plan)


@pytest.mark.parametrize("H,F", [(1, 8), (3, 5)])
def test_bspmm_csr_matches_jax(H, F):
    """Forward and both gradients against the JAX function (one Pallas
    segment matmul a head, interpreted) and against an XLA composition."""
    p = _Plans(13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(p.n_src, H, F)).astype(np.float32)
    a = rng.random((p.E, H)).astype(np.float32)
    g = rng.normal(size=(p.n_dst, H, F)).astype(np.float32)

    def xla(x, a):
        msg = x[jnp.asarray(p.src)] * a[:, :, None]
        return jax.ops.segment_sum(msg, jnp.asarray(p.dst), p.n_dst)

    want, vjp = jax.vjp(lambda x, a: jax_bspmm_csr(x, a, p.jplan),
                        jnp.asarray(x), p.to_lanes(a))
    want_dx, want_da = vjp(jnp.asarray(g))
    xla_out, xla_vjp = jax.vjp(xla, jnp.asarray(x), jnp.asarray(a))
    xla_dx, xla_da = xla_vjp(jnp.asarray(g))
    tx = torch.tensor(x).requires_grad_()
    ta = p.to_csr(a).requires_grad_()
    got = kops.bspmm_csr(tx, ta, p.plan)
    assert got.shape == (p.n_dst, H, F)
    (got * torch.tensor(g)).sum().backward()
    for ref, dx, da, tol in ((want, want_dx, p.from_lanes(want_da), 1e-4),
                             (xla_out, xla_dx, xla_da, 1e-5)):
        _close(got, ref, tol)
        _close(tx.grad, dx, tol)
        _close(p.from_csr(ta.grad), da, tol)
    with pytest.raises(ValueError, match="alpha shape"):
        kops.bspmm_csr(tx, ta[:, :1].expand(-1, H + 1), p.plan)
