"""The CSR kernel's work items (`build_row_split`) and the plain versions on
a graph with hub rows, against the JAX package.

On the card the CSR kernel cuts a row of more than `ROW_SPLIT` edges into
items of consecutive CSR edges, sums each item in f32, and a fold adds a
cut row's partials in item order, starting from prev. Here:

* the schedule's invariants, at small K;
* a numpy emulation that sums by the schedule (partials in slots, folded
  in item order from prev) against the port's plain versions, which the
  card's kernels are held to;
* the plain versions on a hub graph (a star of 20,000 edges into row 0
  plus random edges, N_src != N_dst, empty rows) against the JAX package:
  `ops.spmm` (XLA, f32 1e-5), the Pallas `spmm_csr` and `segment_sum_csr`
  (interpreted off-TPU, 1e-4: their f32 path is a bf16x3 split that drops
  the lo*lo term) and `segment_matmul_dyn_packed(out_acc=)` (bf16 F = 256,
  2e-2 of an f64 reference: the JAX kernel adds bf16 tiles).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import spmm as jax_spmm
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import segment_matmul as jsm
from gammagl_tpu.ops.pallas import segment_sum_csr as jax_segment_sum_csr
from gammagl_tpu.ops.pallas import spmm_csr as jax_spmm_csr
from gammagl_tpu.parallel import halo_plan as jhp

from gammagl_tpu_torch.ops import cuda as kops

STAR = 20_000


def _hub_graph(seed, n_dst=300, n_src=450, e=3000, star=STAR):
    """A star of ``star`` edges into row 0 from random sources, a second
    hub of e // 2 edges into row 4, and ``e`` random edges into even rows
    below 200: odd rows and rows 200.. get none. Edges are shuffled, so
    the hubs' CSR order is the caller's."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(star, np.int64),
                          np.full(e // 2, 4, np.int64),
                          2 * rng.integers(0, 100, e)])
    src = rng.integers(0, n_src, dst.shape[0])
    order = rng.permutation(dst.shape[0])
    return src[order], dst[order], n_dst, n_src


def _close(got, want, rtol):
    """|got - want| <= rtol*|want| + 1e-5*max|want|; the second term covers
    sums taken in different orders."""
    got, want = (a.detach().float().numpy() if isinstance(a, torch.Tensor)
                 else a for a in (got, want))
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


def _rowptrs():
    """Row pointers with empty rows, one-edge rows, rows of exactly K and
    K + 1 edges at K = 4, a hub, and no edges at all."""
    degs = {
        "mixed": [0, 1, 4, 5, 0, 0, 9, 3, 8, 0, 13],
        "hub_first": [41, 0, 2, 2, 0],
        "empty": [0, 0, 0],
        "no_rows": [],
        "one_hub": [17],
    }
    return {k: np.concatenate([[0], np.cumsum(np.asarray(d, np.int64))])
            for k, d in degs.items()}


@pytest.mark.parametrize("name", sorted(_rowptrs()))
@pytest.mark.parametrize("K", [1, 4, 7, 64])
def test_schedule_invariants(name, K):
    rowptr = _rowptrs()[name]
    s = kops.build_row_split(rowptr, K)
    n_rows = rowptr.shape[0] - 1
    deg = np.diff(rowptr)
    E = int(rowptr[-1])
    lo, hi = s.item_ptr[:-1], s.item_ptr[1:]
    # items in CSR order: every edge in exactly one item
    assert s.item_ptr[0] == 0 and s.item_ptr[-1] == E
    assert (hi >= lo).all()
    covered = np.repeat(np.arange(len(lo)), hi - lo)
    assert covered.shape == (E,)
    # each item's edges lie in its row, rows in order, at most K each
    assert (np.diff(s.item_row) >= 0).all()
    assert (lo >= rowptr[s.item_row]).all()
    assert (hi <= rowptr[s.item_row + 1]).all()
    assert (hi - lo <= K).all()
    # every row has ceil(deg / K) items, an empty row exactly one
    per_row = np.bincount(s.item_row, minlength=n_rows)
    np.testing.assert_array_equal(per_row, np.maximum(1, -(-deg // K)))
    assert (hi[deg[s.item_row] == 0] == lo[deg[s.item_row] == 0]).all()
    # slots only for cut rows, numbered in item order
    cut = per_row > 1
    np.testing.assert_array_equal(s.cut_row, np.flatnonzero(cut))
    in_cut = cut[s.item_row]
    assert (s.item_slot[~in_cut] == -1).all()
    np.testing.assert_array_equal(s.item_slot[in_cut],
                                  np.arange(int(in_cut.sum())))
    np.testing.assert_array_equal(np.diff(s.cut_ptr), per_row[cut])
    assert s.item_ptr.dtype == np.int64 and s.cut_ptr.dtype == np.int64
    assert s.item_row.dtype == np.int32 and s.item_slot.dtype == np.int32
    assert s.cut_row.dtype == np.int32


def test_schedule_rejects_a_bad_K():
    with pytest.raises(ValueError, match="positive"):
        kops.build_row_split(np.array([0, 3]), 0)


def _by_schedule(x, w, plan, K, per_edge=False, prev=None):
    """The kernel's arithmetic by its schedule, in float32: each item's
    weighted rows summed; an item that owns its row adds its sum to prev
    (or 0); a cut row's partials go to their slots and are added in item
    order to prev (or 0); every row rounded once to x's dtype."""
    s = kops.build_row_split(plan.rowptr, K)
    E = plan.num_edges
    idx = torch.arange(E) if per_edge else torch.from_numpy(plan.col).long()
    msg = x[idx].float()
    if w is not None:
        w = w.float()
        msg = (msg * w[:, None] if w.dim() == 1 else
               (msg.view(E, w.shape[1], -1) * w[:, :, None]).view(E, -1))
    item_of = torch.from_numpy(np.repeat(np.arange(len(s.item_row)),
                                         np.diff(s.item_ptr)))
    sums = torch.zeros(len(s.item_row), x.shape[1]).index_add_(0, item_of,
                                                               msg)
    out = (torch.zeros(plan.num_nodes, x.shape[1]) if prev is None
           else prev.float().clone())
    own = torch.from_numpy(s.item_slot < 0)
    rows = torch.from_numpy(s.item_row).long()
    out[rows[own]] += sums[own]
    part = sums[torch.from_numpy(s.item_slot >= 0)]  # slot order
    for i, row in enumerate(s.cut_row):
        acc = out[row].clone()
        for slot in range(s.cut_ptr[i], s.cut_ptr[i + 1]):
            acc += part[slot]
        out[row] = acc
    return out.to(x.dtype), s


_DTYPES = [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)]


@pytest.mark.parametrize("K", [64, 1500, 4096])
@pytest.mark.parametrize("F", [7, 40])
@pytest.mark.parametrize("dtype,rtol", _DTYPES)
def test_emulation_matches_spmm_csr_reference(K, F, dtype, rtol):
    src, dst, n_dst, n_src = _hub_graph(1, star=3000)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    g = torch.Generator().manual_seed(F)
    x = torch.randn(n_src, F, generator=g).to(dtype)
    w = torch.rand(plan.num_edges, generator=g)
    got, s = _by_schedule(x, w, plan, K)
    assert (len(s.cut_row) > 0) == (K < 3000)
    _close(got.float(), kops.spmm_csr_reference(x, w, plan,
                                                weights_padded=True), rtol)


@pytest.mark.parametrize("K", [64, 1500])
@pytest.mark.parametrize("F", [7, 128])
@pytest.mark.parametrize("dtype,rtol", _DTYPES)
def test_emulation_matches_spmm_csr_acc_reference(K, F, dtype, rtol):
    src, dst, n_dst, n_src = _hub_graph(2, star=3000)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    g = torch.Generator().manual_seed(F)
    x = torch.randn(n_src, F, generator=g).to(dtype)
    w = torch.rand(plan.num_edges, generator=g)
    prev = torch.randn(n_dst, F, generator=g).to(dtype)
    got, s = _by_schedule(x, w, plan, K, prev=prev)
    assert len(s.cut_row) == 2  # the star and the second hub
    want = kops.spmm_csr_acc_reference(x, w, plan, prev=prev,
                                       weights_padded=True)
    _close(got.float(), want, rtol)
    bare = torch.from_numpy(np.diff(plan.rowptr) == 0)
    assert torch.equal(got[bare], prev[bare])
    assert torch.equal(want[bare], prev[bare])


@pytest.mark.parametrize("K", [64, 1500])
@pytest.mark.parametrize("weights", ["unit", "edge", "head"])
@pytest.mark.parametrize("dtype,rtol", _DTYPES)
def test_emulation_matches_segment_sum_csr_reference(K, weights, dtype,
                                                     rtol):
    src, dst, n_dst, n_src = _hub_graph(3, star=3000)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    g = torch.Generator().manual_seed(4)
    E, C, H = plan.num_edges, 40, 4
    v = torch.randn(E, C, generator=g).to(dtype)
    w = {"unit": None, "edge": torch.rand(E, generator=g),
         "head": torch.rand(E, H, generator=g)}[weights]
    got, _ = _by_schedule(v, w, plan, K, per_edge=True)
    _close(got.float(), kops.segment_sum_csr_reference(v, plan, w), rtol)


def test_plan_caches_its_items_per_device():
    src, dst, n_dst, n_src = _hub_graph(5, star=kops.ROW_SPLIT + 1)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    assert plan.row_split() is plan.row_split()
    ptr, meta, cut_row, cut_ptr, n_slots = plan.split_arrays("cpu")
    assert plan.split_arrays(torch.device("cpu"))[0] is ptr
    assert cut_row.tolist() == [0] and cut_ptr.tolist() == [0, 2]
    assert n_slots == 2 and meta.shape == (plan.row_split().item_row.shape[0],
                                           2)
    np.testing.assert_array_equal(meta[:, 0].numpy(),
                                  plan.row_split().item_row)
    np.testing.assert_array_equal(meta[:, 1].numpy(),
                                  plan.row_split().item_slot)
    # a plan without cut rows: one item per row, rowptr itself
    tp = plan.transpose()
    ptr_t, meta_t, _, _, slots_t = tp.split_arrays("cpu")
    assert meta_t is None and slots_t == 0
    assert ptr_t is tp.arrays("cpu")[0]
    # the reverse graph's hub: a star out of one source
    back = kops.build_csr_plan(dst, src, n_src, num_src=n_dst)
    assert back.transpose().row_split().cut_row.tolist() == [0]
    assert back.edge_scatter_plan().row_split().cut_row.tolist() == [0]


def test_graphs_without_hubs_keep_rows_whole():
    """bench.py's generator at the arxiv shape (dst = N u^1.5 gives the
    largest in-degree, ~760) plus self-loops: no row is cut, so its plans
    launch no fold."""
    n, e = 169_343, 2_315_598
    rng = np.random.default_rng(0)
    dst = (n * (rng.random(e) ** 1.5)).astype(np.int64)
    deg = np.bincount(dst, minlength=n) + 1
    assert 600 < deg.max() < kops.ROW_SPLIT
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    assert len(kops.build_row_split(rowptr).cut_row) == 0


@pytest.fixture(scope="module")
def hub():
    src, dst, n_dst, n_src = _hub_graph(7)
    rng = np.random.default_rng(8)
    w = rng.random(src.shape[0]).astype(np.float32)
    return src, dst, n_dst, n_src, w


@pytest.mark.parametrize("F", [8, 40])
@pytest.mark.parametrize("weights", [False, True])
def test_spmm_on_hub_rows_matches_jax(hub, F, weights):
    src, dst, n_dst, n_src, w = hub
    x = np.random.default_rng(F).normal(size=(n_src, F)).astype(np.float32)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    assert plan.num_edges > STAR and plan.row_split().cut_row[0] == 0
    tw = torch.from_numpy(w) if weights else None
    got = kops.spmm_csr(torch.from_numpy(x), tw, plan)
    jw = jnp.asarray(w) if weights else None
    _close(got, jax_spmm(jnp.asarray(np.stack([src, dst])), jw,
                         jnp.asarray(x), num_nodes=n_dst), 1e-5)
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src)
    _close(got, jax.jit(lambda x, w: jax_spmm_csr(x, w, jplan))(
        jnp.asarray(x), jw), 1e-4)
    assert bool((got[torch.from_numpy(np.diff(plan.rowptr) == 0)] == 0)
                .all())


def test_spmm_on_the_hub_transpose_matches_jax(hub):
    """The reverse graph: the star's row becomes a source of 20,000 edges,
    which the gradient's transpose plan cuts."""
    src, dst, n_dst, n_src, w = hub
    rng = np.random.default_rng(9)
    x = rng.normal(size=(n_src, 16)).astype(np.float32)
    g = rng.normal(size=(n_dst, 16)).astype(np.float32)
    plan = kops.build_csr_plan(dst, src, n_src, num_src=n_dst)
    assert plan.transpose().row_split().cut_row[0] == 0
    tg = torch.from_numpy(g).requires_grad_()
    (kops.spmm_csr(tg, torch.from_numpy(w), plan) * torch.from_numpy(
        x)).sum().backward()
    ei = jnp.asarray(np.stack([dst, src]))
    want = jax.grad(lambda g: jnp.sum(jax_spmm(
        ei, jnp.asarray(w), g, num_nodes=n_src) * x))(jnp.asarray(g))
    _close(tg.grad, want, 1e-5)


@pytest.mark.parametrize("weights", [False, True])
def test_segment_sum_on_hub_rows_matches_jax(hub, weights):
    src, dst, n_dst, n_src, w = hub
    E, C = src.shape[0], 8
    rng = np.random.default_rng(10)
    v = rng.normal(size=(E, C)).astype(np.float32)  # caller's edge order
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    wl = w if weights else np.ones(E, np.float32)
    got = kops.segment_sum_csr(torch.from_numpy(v[plan.perm]), plan,
                               torch.from_numpy(w[plan.perm]) if weights
                               else None)
    _close(got, jax.ops.segment_sum(jnp.asarray(v * wl[:, None]),
                                    jnp.asarray(dst), num_segments=n_dst),
           1e-5)
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src)
    lanes = np.zeros((len(jplan.valid), C), np.float32)
    lanes[jplan.valid] = (v * wl[:, None])[jplan.perm[jplan.valid]]
    _close(got, jax.jit(lambda m: jax_segment_sum_csr(m, jplan))(
        jnp.asarray(lanes)), 1e-4)


def test_spmm_csr_acc_on_hub_rows_matches_the_jax_packed_kernel(hub):
    src, dst, n_dst, n_src, w = hub
    R, ET, F = 8, 512, 256
    rng = np.random.default_rng(11)
    w = rng.normal(size=src.shape[0]).astype(np.float32)
    bf = jnp.bfloat16
    x = np.asarray(jnp.asarray(rng.normal(size=(n_src, F)), bf), np.float32)
    prev = np.asarray(jnp.asarray(rng.normal(size=(n_dst, F)), bf),
                      np.float32)
    jplan = jsm.build_csr_plan(src, dst, n_dst, num_src=n_src, R=R, ET=ET)
    nblocks = -(-n_dst // R)
    g = jnp.take(jsm.pack_halves(jnp.asarray(x, bf)),
                 jnp.asarray(jplan.src_pad), axis=0)
    prev_pad = jnp.zeros((nblocks * R, F), bf).at[:n_dst].set(
        jnp.asarray(prev, bf))
    want = np.asarray(jsm.segment_matmul_dyn_packed(
        g, jnp.asarray(jhp._permute_w(w, jplan)),
        jnp.asarray(jplan.local_row), jnp.asarray(jplan.tile_block),
        jnp.asarray(jplan.tile_first), R=R, ET=ET, nblocks=nblocks,
        interpret=True, out_acc=prev_pad)[:n_dst].astype(jnp.float32))
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    tb = torch.bfloat16
    prev_t = torch.from_numpy(prev).to(tb)
    got = kops.spmm_csr_acc(torch.from_numpy(x).to(tb), torch.from_numpy(w),
                            plan, prev=prev_t).float().numpy()
    a = np.zeros((n_dst, n_src))
    np.add.at(a, (dst, src), w)
    ref = prev.astype(np.float64) + a @ x.astype(np.float64)
    for out in (got, want):
        np.testing.assert_allclose(out, ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    bare = np.diff(plan.rowptr) == 0
    np.testing.assert_array_equal(got[bare], prev[bare])
    np.testing.assert_array_equal(want[bare], prev[bare])
