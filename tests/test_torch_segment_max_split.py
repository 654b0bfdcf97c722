"""The segment max kernels' schedule on a graph with hub rows, emulated in
numpy, against the JAX package.

On the card the segment max walks the CSR kernel's work items: a row of
more than `ROW_SPLIT` edges is cut into items of consecutive CSR edges.
An item of a cut row stores its partial maximum (-inf where it has no
winner), and a fold takes each cut row's maximum over its items in item
order, applying the rule for an infinite winner (it gives 0) once, to the
row's final value. The backward counts each item's winners per column,
sums a cut row's counts in item order, and only then writes the shares
``g / max(count, 1)``, rounded to the messages' dtype.

Here that schedule, at small K, is held bitwise to the JAX package on the
hub graph of `test_torch_row_split.py` (a star of 2,000 edges into row 0,
a second hub into row 4, empty rows, N_src != N_dst): its Pallas kernels
`spmm_max_csr` / `spmm_min_csr` and `segment_max_csr` / `segment_min_csr`
in interpret mode, XLA's ``segment_max`` / ``segment_min``, and the port's
plain versions; with integer-valued features (ties inside and across
items), weights, an item whose messages are all -inf (+inf for the min),
and a column whose every message in a cut row is. Its cotangents are held
to ``jax.vjp`` of the same functions: the per-edge ones equal (up to the
sign of a zero), and bitwise to the port's plain backward; dx and dw,
sums over edges and columns, within 1e-5 of their largest value.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu import ops as jops
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import segment_max as jsm

from gammagl_tpu_torch.ops import cuda as k
from tests.test_torch_row_split import _hub_graph
from tests.test_torch_segment_max import _bits_equal, _from_pad, _pad_order

STAR = 2000
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
GATHERED = {"max": (jsm.spmm_max_csr, jops.segment_max,
                    k.spmm_max_csr_reference),
            "min": (jsm.spmm_min_csr, jops.segment_min,
                    k.spmm_min_csr_reference)}
PER_EDGE = {"max": (jsm.segment_max_csr, jops.segment_max,
                    k.segment_max_csr_reference),
            "min": (jsm.segment_min_csr, jops.segment_min,
                    k.segment_min_csr_reference)}


# the Pallas bf16 pick is a one-hot matmul, whose 0 * inf gives NaN in a
# column with infinite messages (`test_infinite_winners_give_zero_as_jax`):
# there the schedule is held to XLA and the plain version alone
_FINITE = {"f32": slice(None), "bf16": [0, 1, 2, 4, 5, 6, 7]}


def _graph(seed):
    src, dst, n_dst, n_src = _hub_graph(seed, star=STAR)
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src)
    tplan = k.build_csr_plan(src, dst, n_dst, num_src=n_src)
    return src, dst, n_dst, n_src, jplan, tplan


def _round(a, tdt):
    """float32 numpy values rounded to the torch dtype and widened back."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt).float().numpy()


def _messages(x, w, tplan, tdt):
    """(E, F) float32 messages in CSR order: x[col[e]] times w_e rounded to
    the dtype, the product rounded to it; and the raw rows x[col[e]]."""
    raw = x[tplan.col]
    if w is None:
        return raw, raw
    return _round(raw * _round(w[tplan.perm], tdt)[:, None], tdt), raw


def _items(tplan, K):
    """(items' edge ranges, rows, slots) and the cut rows' slot ranges of
    `build_row_split` at K, as the kernels walk them."""
    s = k.build_row_split(tplan.rowptr, K)
    assert len(s.cut_row) == 2  # the star and the second hub
    return s


def _schedule_forward(msg, tplan, K, negate):
    """The forward by the kernels' schedule: per item the running maximum
    of its messages (negated for the min), taking a message only when it
    is larger; an item that owns its row applies the infinite-winner rule
    and writes; a cut row's partials are folded in item order by the same
    rule, then the infinite-winner rule applies once."""
    s = _items(tplan, K)
    sign = -1.0 if negate else 1.0
    F = msg.shape[1]
    out = np.zeros((tplan.num_nodes, F), np.float32)
    part = np.full((int(s.cut_ptr[-1]), F), -np.inf, np.float32)
    for i in range(len(s.item_row)):
        m = np.full(F, -np.inf, np.float32)
        for e in range(s.item_ptr[i], s.item_ptr[i + 1]):
            v = sign * msg[e]
            m = np.where(v > m, v, m)
        if s.item_slot[i] < 0:
            out[s.item_row[i]] = np.where(m == -np.inf, 0.0, sign * m)
        else:
            part[s.item_slot[i]] = m
    for i, row in enumerate(s.cut_row):
        acc = np.full(F, -np.inf, np.float32)
        for slot in range(s.cut_ptr[i], s.cut_ptr[i + 1]):
            acc = np.where(part[slot] > acc, part[slot], acc)
        out[row] = np.where(acc == -np.inf, 0.0, sign * acc)
    return out, s


def _schedule_backward(msg, raw, out, g, tplan, K, tdt):
    """dmsg (E, F) and dw (E,) by the kernels' schedule: each item counts
    its winners per column; a cut row's counts are summed in item order
    before any share is written; shares g / max(count, 1) rounded to the
    dtype; dw per edge over its columns (None without raw rows)."""
    s = _items(tplan, K)
    rows = np.repeat(np.arange(tplan.num_nodes), np.diff(tplan.rowptr))
    eq = msg == out[rows]
    counts = np.stack([eq[s.item_ptr[i]:s.item_ptr[i + 1]].sum(0)
                       for i in range(len(s.item_row))]).astype(np.float32)
    cnt = np.zeros_like(out)
    own = s.item_slot < 0
    cnt[s.item_row[own]] = counts[own]
    slots = counts[~own]  # slot order: the cut items in item order
    for i, row in enumerate(s.cut_row):
        total = np.zeros(out.shape[1], np.float32)
        for slot in range(s.cut_ptr[i], s.cut_ptr[i + 1]):
            total = total + slots[slot]
        cnt[row] = total
    share = _round(g / np.maximum(cnt, 1.0), tdt)
    dmsg = np.where(eq, share[rows], 0.0).astype(np.float32)
    return dmsg, None if raw is None else (dmsg * raw).sum(1)


def _features(seed, n, F, tdt):
    """Integer-valued features in [-3, 3]: ties inside and across items."""
    rng = np.random.default_rng(seed)
    return _round(rng.integers(-3, 4, (n, F)), tdt)


@pytest.mark.parametrize("K", [64, 700])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_gathered_schedule_is_bitwise_equal_to_jax(op, dtype, weighted, K):
    src, dst, n_dst, n_src, jplan, tplan = _graph(1)
    jdt, tdt = DTYPES[dtype]
    F = 8 if dtype == "f32" else 16
    x = _features(2, n_src, F, tdt)
    x[src[dst == 0][:40], 3] = -np.inf if op == "max" else np.inf
    w = (_round(np.random.default_rng(3).integers(1, 5, len(src)) / 4, tdt)
         if weighted else None)
    msg, _ = _messages(x, w, tplan, tdt)
    got, _ = _schedule_forward(msg, tplan, K, op == "min")
    pallas, xla, plain = GATHERED[op]
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(pallas(jnp.asarray(x, jdt), jw, jplan, interpret=True),
                      np.float32)
    _bits_equal(torch.from_numpy(got[:, _FINITE[dtype]]),
                want[:, _FINITE[dtype]])
    jmsg = jnp.asarray(x, jdt)[jnp.asarray(src)]
    if w is not None:
        jmsg = jmsg * jw.astype(jdt)[:, None]
    _bits_equal(torch.from_numpy(got), xla(jmsg, jnp.asarray(dst), n_dst))
    _bits_equal(torch.from_numpy(got), plain(
        torch.from_numpy(x).to(tdt), None if w is None else
        torch.from_numpy(w), tplan))


@pytest.mark.parametrize("K", [64, 700])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_per_edge_schedule_with_infinite_items_matches_jax(op, dtype, K):
    """Per-edge rows: the star's first item holds only -inf (+inf for the
    min) in column 0, every edge of the star in column 1 (the row gives 0
    there), ties across the star's items in the other columns."""
    src, dst, n_dst, n_src, jplan, tplan = _graph(4)
    jdt, tdt = DTYPES[dtype]
    inf = -np.inf if op == "max" else np.inf
    rng = np.random.default_rng(5)
    msg = _round(rng.integers(-3, 4, (len(src), 6)), tdt)  # caller order
    star = np.flatnonzero(dst == 0)  # CSR order keeps the caller's order
    msg[star[:K], 0] = inf
    msg[star, 1] = inf
    csr = msg[tplan.perm]
    got, s = _schedule_forward(csr, tplan, K, op == "min")
    assert s.cut_row[0] == 0 and s.item_ptr[1] - s.item_ptr[0] == K
    assert got[0, 1] == 0 and np.isfinite(got[0, 0])
    pallas, xla, plain = PER_EDGE[op]
    want = np.asarray(pallas(jnp.asarray(_pad_order(jplan, msg), jdt), jplan,
                             interpret=True), np.float32)
    cols = slice(2, None) if dtype == "bf16" else slice(None)
    _bits_equal(torch.from_numpy(got[:, cols]), want[:, cols])
    _bits_equal(torch.from_numpy(got), xla(jnp.asarray(msg, jdt),
                                           jnp.asarray(dst), n_dst))
    _bits_equal(torch.from_numpy(got), plain(
        torch.from_numpy(csr).to(tdt), tplan))


@pytest.mark.parametrize("K", [64, 700])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_per_edge_backward_schedule_is_bitwise_equal_to_jax_vjp(op, dtype,
                                                               K):
    """Tied winners of the star lie in many items: their count is summed
    over the items before the share is written."""
    src, dst, n_dst, n_src, jplan, tplan = _graph(6)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    msg = _round(rng.integers(-2, 3, (len(src), 5)), tdt)
    msg[dst == 0, 2] = -np.inf if op == "max" else np.inf
    csr = msg[tplan.perm]
    out, _ = _schedule_forward(csr, tplan, K, op == "min")
    g = _round(rng.normal(size=out.shape), tdt)
    dmsg, _ = _schedule_backward(csr, None, out, g, tplan, K, tdt)
    star = slice(tplan.rowptr[0], tplan.rowptr[1])
    for c in (0, 1, 3, 4):  # the star's tied winners lie in several items
        assert len(np.unique(np.flatnonzero(csr[star, c] == out[0, c])
                             // K)) > 1
    pallas = PER_EDGE[op][0]
    _, vjp = jax.vjp(lambda m: pallas(m, jplan, interpret=True),
                     jnp.asarray(_pad_order(jplan, msg), jdt))
    want = _from_pad(jplan, np.asarray(vjp(jnp.asarray(g, jdt))[0],
                                       np.float32))
    got = np.zeros_like(want)
    got[tplan.perm] = dmsg
    # equal values (JAX's min gives -0.0 where no edge wins: its negations);
    # in bf16 the Pallas forward's NaN in the infinite column reaches the
    # other rows of the star's block, which then take no share there
    cols = [0, 1, 3, 4] if dtype == "bf16" else slice(None)
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    assert (dmsg[star][:, 2] == 0).all()  # an infinite winner: no share
    t_csr = torch.from_numpy(csr).to(tdt)
    ref, _ = k.segment_max_bwd_reference(
        t_csr, None, torch.from_numpy(out).to(tdt),
        torch.from_numpy(g).to(tdt), tplan, True, False)
    _bits_equal(ref, dmsg)


@pytest.mark.parametrize("K", [64, 700])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("op", ["max", "min"])
def test_gathered_backward_schedule_matches_jax_vjp(op, weighted, K):
    """f32: dx (the shares summed into source rows, times the weight) and
    dw (each edge's share against its raw row) against jax.vjp of the
    Pallas kernel, within 1e-5 of their largest value; dmsg bitwise
    against the port's plain backward."""
    src, dst, n_dst, n_src, jplan, tplan = _graph(8)
    jdt, tdt = DTYPES["f32"]
    x = _features(9, n_src, 6, tdt)
    w = (np.random.default_rng(10).integers(1, 5, len(src)) / 4).astype(
        np.float32) if weighted else None
    msg, raw = _messages(x, w, tplan, tdt)
    out, _ = _schedule_forward(msg, tplan, K, op == "min")
    g = np.random.default_rng(11).normal(size=out.shape).astype(np.float32)
    dmsg, dw = _schedule_backward(msg, raw, out, g, tplan, K, tdt)
    w_csr = np.ones(len(src), np.float32) if w is None else w[tplan.perm]
    dx = np.zeros_like(x)
    np.add.at(dx, tplan.col, dmsg * w_csr[:, None])
    pallas = GATHERED[op][0]
    args = (jnp.asarray(x),) + (() if w is None else (jnp.asarray(w),))
    _, vjp = jax.vjp(lambda a, *b: pallas(a, b[0] if b else None, jplan,
                                          interpret=True), *args)
    want = vjp(jnp.asarray(g))
    ref = np.asarray(want[0])
    np.testing.assert_allclose(dx, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if weighted:
        ref_dw = np.zeros(len(src), np.float32)
        ref_dw[tplan.perm] = dw
        jdw = np.asarray(want[1])
        np.testing.assert_allclose(ref_dw, jdw, rtol=0,
                                   atol=1e-5 * np.abs(jdw).max())
    t_w = None if w is None else torch.from_numpy(w_csr)
    r_dmsg, r_dw = k.segment_max_bwd_reference(
        torch.from_numpy(x), t_w, torch.from_numpy(out),
        torch.from_numpy(g), tplan, False, weighted)
    _bits_equal(r_dmsg, dmsg)
    if weighted:
        np.testing.assert_allclose(r_dw.numpy(), dw, rtol=0,
                                   atol=1e-5 * np.abs(dw).max())
