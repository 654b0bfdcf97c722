"""The SDDMM kernel's work items and its arithmetic, emulated in numpy,
against the JAX package.

On the card the SDDMM cuts the plan's rows into work items of at most
`EDGE_SPLIT` consecutive CSR edges (`build_row_split` at that K; a hub
row becomes many items) and gives each item a group of lanes: a lane
takes V columns of one head (V the widest load the alignment allows),
Lh lanes a head (the power of two >= F / V, at most 32) and the heads of
a pass fill at most 32 lanes; a head wider than 32 V columns takes
ceil(F / (32 V)) column chunks a lane. Each edge's score is its own
output, so an item of a cut row writes its own edges and nothing is
folded. Here:

* the schedule at small K (4, 16) on a hub graph, on a graph with empty
  rows and on E = 0: every CSR edge lies in exactly one item, in its
  row; the plan caches each K's table apart from the CSR kernels';
* a numpy emulation of the kernel's walk: per item, per lane, the
  partial dot over the lane's V columns of each chunk in order, then the
  xor tree over the head's lanes, against the JAX `sddmm_csr` /
  `sddmm_csr_mh` (Pallas, interpreted off-TPU), gathered rows and the
  ``msg=`` form, at the (H, F) the card's tests run, f32 at 1e-5 of
  max |score| (sums in other orders);
* the kernel's batched head sums (`head_sums` in csrc/sddmm_csr.cu: runs
  of kSddmmBatch edges, the tree's first levels transposed) emulated
  lane by lane: bitwise the per-edge xor tree's sums, each landing on the
  lane that stores it;
* the plain version, which the card's kernel is held to, on a star of
  20,000 edges against the JAX package, both forms, f32 at 1e-5.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import sddmm as jax_sddmm_coo
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import sddmm_csr as jax_sddmm_csr
from gammagl_tpu.ops.pallas import sddmm_csr_mh as jax_sddmm_csr_mh

from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops.cuda.sddmm_csr import EDGE_SPLIT

# the (H, F) of the card's tests (tests/test_torch_cuda.py)
SHAPES = [(1, 7), (8, 8), (1, 40), (1, 256), (2, 640)]
# the widest load of a lane, in elements: 16 bytes of bf16 or f32, and a
# pointer off by one element (one element a lane)
VMAX = {"bf16": 8, "f32": 4, "misaligned": 1}


def _hub_graph(seed, n_dst=60, n_src=80, e=400, star=300):
    """A star of ``star`` edges into row 0, a hub of e // 4 into row 6
    and ``e`` random edges into even rows below 40: odd rows and rows
    40.. get none. Shuffled, so the CSR order is not the caller's."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(star, np.int64),
                          np.full(e // 4, 6, np.int64),
                          2 * rng.integers(0, 20, e)])
    src = rng.integers(0, n_src, dst.shape[0])
    order = rng.permutation(dst.shape[0])
    return src[order], dst[order], n_dst, n_src


def _geometry(H, F, vmax):
    """The kernel's lane layout (pick_sddmm_geom): V, log2 Lh, heads a
    pass, column chunks a lane and passes."""
    V = vmax
    while F % V:
        V //= 2
    per_head = F // V
    lh = 0
    while lh < 5 and (1 << lh) < per_head:
        lh += 1
    heads = 1
    while (heads << lh) < 32 and heads < H:
        heads *= 2
    return V, lh, heads, -(-per_head // (1 << lh)), -(-H // heads)


def _emulate(a, xd, plan, H, F, gather, K, vmax):
    """The kernel's scores (E, H) f32 in CSR order, by its schedule: the
    items of `build_row_split(K)`, each edge of an item dotted with the
    item's row; per lane the products of its V columns of each chunk
    added in order, then the head's Lh partials added by the xor tree.
    Checks that every edge is written exactly once."""
    V, lh, heads, n_chunks, passes = _geometry(H, F, vmax)
    Lh = 1 << lh
    split = kops.build_row_split(plan.rowptr, K)
    E = plan.num_edges
    item_of = np.repeat(np.arange(split.item_row.shape[0]),
                        np.diff(split.item_ptr))
    np.testing.assert_array_equal(np.bincount(np.concatenate(
        [np.arange(lo, hi) for lo, hi in zip(split.item_ptr[:-1],
                                             split.item_ptr[1:])]
        + [np.zeros(0, np.int64)]), minlength=E), np.ones(E))
    rows = split.item_row[item_of]  # each edge's row, as its item says
    src = plan.col if gather else np.arange(E)
    A = a[src].reshape(E, H, F).astype(np.float32)
    X = xd[rows].reshape(E, H, F).astype(np.float32)
    out = np.zeros((E, H), np.float32)
    for p in range(passes):
        for hh in range(heads):
            h = p * heads + hh
            if h >= H:
                continue
            part = np.zeros((Lh, E), np.float32)
            for li in range(Lh):
                for k in range(n_chunks):
                    c = (k * Lh + li) * V
                    if c >= F:
                        continue
                    for i in range(V):
                        part[li] = part[li] + A[:, h, c + i] * X[:, h, c + i]
            off = Lh // 2
            while off:
                part = part + part[np.arange(Lh) ^ off]
                off //= 2
            out[:, h] = part[0]
    return out


def _to_caller(v, plan):
    out = np.zeros(v.shape, np.float32)
    out[plan.perm] = np.asarray(v, np.float32)
    return out


def _close(got, want, rtol=1e-5):
    """|got - want| <= rtol*|want| + 1e-5*max|want|: sums in other
    orders."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


def _rowptrs():
    """A hub graph's, one with empty rows (and rows of exactly K and K + 1
    edges at K = 4 and 16), and E = 0."""
    src, dst, n_dst, n_src = _hub_graph(0)
    hub = kops.build_csr_plan(src, dst, n_dst, num_src=n_src).rowptr
    degs = [0, 4, 5, 0, 16, 17, 1, 0, 33, 0]
    empty_rows = np.concatenate([[0], np.cumsum(degs)]).astype(np.int64)
    return {"hub": hub, "empty rows": empty_rows,
            "E=0": np.zeros(6, np.int64)}


@pytest.mark.parametrize("name", sorted(_rowptrs()))
@pytest.mark.parametrize("K", [4, 16])
def test_items_cover_every_edge_once(name, K):
    rowptr = _rowptrs()[name]
    s = kops.build_row_split(rowptr, K)
    E, n_rows = int(rowptr[-1]), rowptr.shape[0] - 1
    lo, hi = s.item_ptr[:-1], s.item_ptr[1:]
    assert s.item_ptr[0] == 0 and s.item_ptr[-1] == E
    # consecutive items, each inside its row, at most K edges
    np.testing.assert_array_equal(lo[1:], hi[:-1])
    assert (hi - lo <= K).all() and (hi >= lo).all()
    assert (lo >= rowptr[s.item_row]).all()
    assert (hi <= rowptr[s.item_row + 1]).all()
    edge_item = np.repeat(np.arange(lo.shape[0]), hi - lo)
    assert edge_item.shape == (E,)
    edge_row = np.repeat(np.arange(n_rows), np.diff(rowptr))
    np.testing.assert_array_equal(s.item_row[edge_item], edge_row)
    # a row of deg edges is ceil(deg / K) items, an empty row one
    np.testing.assert_array_equal(
        np.bincount(s.item_row, minlength=n_rows),
        np.maximum(1, -(-np.diff(rowptr) // K)))


def test_plan_caches_each_item_size_apart():
    """`split_arrays` at the SDDMM's K leaves the CSR kernels' table (at
    ROW_SPLIT) as it was, and keeps one copy per K."""
    src, dst, n_dst, n_src = _hub_graph(1, star=5000)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    csr = plan.split_arrays("cpu")
    small = plan.split_arrays("cpu", 16)
    assert plan.split_arrays("cpu", 16) is small
    assert plan.split_arrays("cpu") is csr
    want = kops.build_row_split(plan.rowptr)
    np.testing.assert_array_equal(csr[0].numpy(), want.item_ptr)
    assert csr[4] == int(want.cut_ptr[-1])
    want16 = kops.build_row_split(plan.rowptr, 16)
    np.testing.assert_array_equal(small[0].numpy(), want16.item_ptr)
    np.testing.assert_array_equal(small[1][:, 0].numpy(), want16.item_row)
    assert plan.row_split(16) is plan.row_split(16)
    assert 2 <= EDGE_SPLIT <= kops.ROW_SPLIT


def _xor_tree(v):
    """v (Lh,) f32 lane partials -> (Lh,) the tree's sum on every lane."""
    v = v.copy()
    off = v.shape[0] // 2
    while off:
        v = v + v[np.arange(v.shape[0]) ^ off]
        off //= 2
    return v


def _head_sums(p, lh, b):
    """head_sums<2^b> lane by lane: p (Lh, B) f32, each lane's partials of
    the run's B edges -> (Lh,) the value each lane ends with."""
    Lh, B = 1 << lh, 1 << b
    lanes = np.arange(Lh)
    p = p.copy()
    o, live = Lh // 2, B
    while live > 1:
        up = (lanes & o) != 0
        half = live // 2
        mine = np.where(up[:, None], p[:, half:live], p[:, :half])
        theirs = np.where(up[:, None], p[:, :half], p[:, half:live])
        p[:, :half] = mine + theirs[lanes ^ o]  # the partner's shuffle
        live, o = half, o // 2
    q = p[:, 0]
    while o:
        q = q + q[lanes ^ o]
        o //= 2
    return q


@pytest.mark.parametrize("lh", [3, 4, 5])
def test_batched_head_sums_are_the_trees_bits(lh):
    src = (Path(__file__).resolve().parents[1] / "gammagl_tpu_torch" / "csrc"
           / "sddmm_csr.cu").read_text()
    B = int(re.search(r"constexpr int kSddmmBatch = (\d+);", src)[1])
    b = B.bit_length() - 1
    assert 1 << b == B and B <= 1 << lh
    rng = np.random.default_rng(lh)
    Lh = 1 << lh
    p = rng.normal(size=(Lh, B)).astype(np.float32) * 10 ** rng.integers(
        -3, 4, (Lh, B)).astype(np.float32)
    got = _head_sums(p, lh, b)
    for lane in range(Lh):
        held = lane >> (lh - b)  # the edge of the run the lane holds
        want = _xor_tree(p[:, held])
        assert got[lane].tobytes() == want[lane].tobytes()
        assert (want == want[0]).all()


def _jax_scores(xs, xd, msg, src, dst, n_dst, n_src, H):
    """JAX `sddmm_csr` / `sddmm_csr_mh` (Pallas, interpreted) in the
    caller's edge order: gathered rows, or ``msg`` (E, H, F) per-edge rows
    in the caller's order."""
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src, R=8, ET=32)
    valid = jplan.valid
    if msg is not None:
        lanes = np.zeros((valid.shape[0],) + msg.shape[1:], np.float32)
        lanes[valid] = msg[jplan.perm[valid]]
        msg = jnp.asarray(lanes)
    if H == 1:
        m = None if msg is None else msg[:, 0]
        s = jax_sddmm_csr(None if xs is None else jnp.asarray(xs[:, 0]),
                          jnp.asarray(xd[:, 0]), jplan, msg=m)[:, None]
    else:
        s = jax_sddmm_csr_mh(None if xs is None else jnp.asarray(xs),
                             jnp.asarray(xd), jplan, msg=msg)
    s = np.asarray(s, np.float32)
    out = np.zeros((len(src), H), np.float32)
    out[jplan.perm[valid]] = s[valid]
    return out


@pytest.mark.parametrize("H,F", SHAPES)
@pytest.mark.parametrize("form", ["gather", "msg"])
def test_kernel_walk_matches_jax(H, F, form):
    src, dst, n_dst, n_src = _hub_graph(H * F)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    rng = np.random.default_rng(F)
    E = len(src)
    xs = rng.normal(size=(n_src, H, F)).astype(np.float32)
    xd = rng.normal(size=(n_dst, H, F)).astype(np.float32)
    msg = (rng.normal(size=(E, H, F)).astype(np.float32)
           if form == "msg" else None)
    gather = msg is None
    want = (_jax_scores(xs, xd, None, src, dst, n_dst, n_src, H) if gather
            else _jax_scores(None, xd, msg, src, dst, n_dst, n_src, H))
    a = xs.reshape(n_src, H * F) if gather else msg[plan.perm].reshape(E, -1)
    for vmax in VMAX.values():
        for K in (4, 16, EDGE_SPLIT):
            got = _emulate(a, xd.reshape(n_dst, -1), plan, H, F, gather, K,
                           vmax)
            _close(_to_caller(got, plan), want)
    # the plain version the card's kernel is held to
    plain = kops.sddmm_csr_reference(torch.from_numpy(a),
                                     torch.from_numpy(xd.reshape(n_dst, -1)),
                                     plan, H, gather)
    _close(_to_caller(plain.numpy(), plan), want)


@pytest.mark.parametrize("H,F", [(1, 256), (8, 8)])
@pytest.mark.parametrize("form", ["gather", "msg"])
def test_plain_version_on_a_star_matches_jax(H, F, form):
    """A 20,000-edge star (cut into 157 items at K = 128): the plain
    version against XLA's COO dot and the JAX kernel, both forms."""
    src, dst, n_dst, n_src = _hub_graph(7, n_src=3000, e=2000, star=20_000)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    assert plan.row_split(EDGE_SPLIT).cut_row.shape[0] >= 1
    rng = np.random.default_rng(8)
    E = len(src)
    xs = rng.normal(size=(n_src, H, F)).astype(np.float32)
    xd = rng.normal(size=(n_dst, H, F)).astype(np.float32)
    if form == "msg":
        msg = rng.normal(size=(E, H, F)).astype(np.float32)
        want_j = _jax_scores(None, xd, msg, src, dst, n_dst, n_src, H)
        ei = np.stack([np.arange(E), dst])
        want_x = np.asarray(jax_sddmm_coo(jnp.asarray(ei), jnp.asarray(msg),
                                          jnp.asarray(xd), "dot"))
        a = msg[plan.perm].reshape(E, -1)
    else:
        want_j = _jax_scores(xs, xd, None, src, dst, n_dst, n_src, H)
        want_x = np.asarray(jax_sddmm_coo(jnp.asarray(np.stack([src, dst])),
                                          jnp.asarray(xs), jnp.asarray(xd),
                                          "dot"))
        a = xs.reshape(n_src, -1)
    got = kops.sddmm_csr_reference(torch.from_numpy(a),
                                   torch.from_numpy(xd.reshape(n_dst, -1)),
                                   plan, H, form == "gather")
    got = _to_caller(got.numpy(), plan)
    _close(got, want_x.reshape(E, H))
    _close(got, want_j)
