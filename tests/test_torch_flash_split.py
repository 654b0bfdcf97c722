"""The flash forward's schedule on a graph with hub rows, emulated in numpy,
against the JAX package.

On the card the flash forward walks the CSR kernel's work items: a row of
more than `ROW_SPLIT` edges is cut into items of consecutive CSR edges.
Each item runs the online softmax over its edges in CSR order (one exp an
edge: exp(-|s - m|) is the rescale of the running sums at a new maximum,
else the edge's weight). An item that owns its row writes out = acc /
max(l, 1e-16), m and l; an item of a cut row writes its partial (m, l,
acc) into its scratch slot, and a fold merges each cut row's partials in
item order by the same recurrence (m = max_i m_i, l and acc the items'
sums each rescaled by exp(m_i - m)). An item without edges is m = -1e30,
l = 0.

Here that schedule, at a small K, is emulated in numpy float32 on a graph
with a star of 2,000 edges into row 0, rows of exactly K, K + 1 and 2K
edges, short rows, empty rows and N_src != N_dst, with the keep mask 0 on
every edge of one of the star's items; and on a graph without edges. At
GAT's (8, 8) and (1, 40), HGT's (4, 64) and a wide (2, 640), f32 and bf16,
node rows gathered at each edge's source (keep in the caller's order) and
per-edge rows in CSR order, it is held to the port's plain
`flash_forward_reference`, to an XLA composition of the JAX package's
`segment_softmax` and segment sums, and to the Pallas `_flash_forward_mh`
in interpret mode. The folded m and l then feed the port's plain backward,
whose gradients are held to `jax.vjp` of the XLA composition.

Tolerances, |got - ref| <= rtol*|ref| + atol*max|ref| (ROADMAP C): f32
against XLA and the plain version rtol = atol = 1e-5 (sums in other
orders), against Pallas 1e-4 (its f32 products are bf16x3 splits); bf16
against an f32 reference of the same bf16 inputs 2e-2. The row maxima m
are equal: every path takes the maximum of the same f32 scores.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import segment_softmax as jax_segment_softmax
from gammagl_tpu.ops.pallas.flash_attention import _flash_forward_mh
from gammagl_tpu.ops.segment import segment_sum as jax_segment_sum

from gammagl_tpu_torch.ops import cuda as k
from tests.test_torch_flash_attention import _JaxLanes

K, STAR, SLOPE, RATE = 64, 2000, 0.2, 0.4
N_DST, N_SRC = 48, 70
LAYOUTS = [(8, 8), (1, 40), (4, 64), (2, 640)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _graph(seed):
    """Caller-order edges: the star into row 0, K edges into row 3, K + 1
    into row 5, 2K into row 7, short rows among the even rows 8..38; odd
    rows and rows 40.. have none. Shuffled, so CSR order is a permutation
    of the caller's."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(STAR, np.int64), np.full(K, 3),
                          np.full(K + 1, 5), np.full(2 * K, 7),
                          2 * rng.integers(4, 20, 300)])
    src = rng.integers(0, N_SRC, dst.shape[0])
    order = rng.permutation(dst.shape[0])
    return src[order], dst[order]


def _round(a, tdt):
    """float32 numpy values rounded to the torch dtype and widened back."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt).float().numpy()


def _case(seed, H, F, tdt, gather, edges=None):
    """Inputs in the caller's order: score and msg node rows (gather) or
    per-edge rows, a_dst, a keep mask zero on every edge of the star's
    second item, the cotangent; and the port's plan."""
    src, dst = _graph(seed) if edges is None else edges
    rng = np.random.default_rng(seed + 1)
    rows = N_SRC if gather else len(src)
    plan = k.build_csr_plan(src, dst, N_DST, num_src=N_SRC)
    keep = (rng.random((len(src), H)) < 1 - RATE).astype(np.float32)
    keep /= np.float32(1 - RATE)
    if len(src):
        keep[plan.perm[plan.rowptr[0] + K:plan.rowptr[0] + 2 * K]] = 0.0
    return dict(
        src=src, dst=dst, n_dst=N_DST, n_src=N_SRC, H=H, F=F, plan=plan,
        score=rng.normal(size=(rows, H)).astype(np.float32),
        a=rng.normal(size=(N_DST, H)).astype(np.float32),
        msg=_round(rng.normal(size=(rows, H * F)), tdt), keep=keep,
        g=rng.normal(size=(N_DST, H * F)).astype(np.float32))


def _csr_inputs(c, gather):
    """Per CSR edge: the leaky score s (E, H), the messages (E, H, F) and
    keep (E, H), float32 numpy."""
    plan, H = c["plan"], c["H"]
    rows = np.repeat(np.arange(N_DST), np.diff(plan.rowptr))
    r = plan.col.astype(np.int64) if gather else plan.perm
    z = c["score"][r] + c["a"][rows]
    s = np.where(z >= 0, z, np.float32(SLOPE) * z)
    return s, c["msg"][r].reshape(len(r), H, c["F"]), c["keep"][plan.perm]


def _merge(m, l, acc, mi, li, ai):
    """One step of the online softmax, per head: (m, l, acc) takes a term
    of maximum mi, mass li and sum ai (an edge: its score, 1 and keep *
    msg; an item's partial: its m, l and acc) with one exp, exp(-|mi -
    m|): the rescale of the running sums at a new maximum, else the
    term's weight."""
    d = mi - m
    t = np.exp(-np.abs(d))
    up = d > 0
    scale = np.where(up, t, np.float32(1))
    w = np.where(up, np.float32(1), t)
    return (np.where(up, mi, m), l * scale + li * w,
            acc * scale[:, None] + w[:, None] * ai)


def _schedule_forward(c, gather, tdt, Kx=K):
    """out (N, H, F) rounded to the dtype, m and l (N, H) by the kernel's
    schedule at K = Kx: the items' online softmax in CSR order, then the
    fold of the cut rows' partials in item order."""
    s, msg, keep = _csr_inputs(c, gather)
    H, F = c["H"], c["F"]
    split = k.build_row_split(c["plan"].rowptr, Kx)
    out = np.zeros((N_DST, H, F), np.float32)
    m_out = np.full((N_DST, H), -1e30, np.float32)
    l_out = np.zeros((N_DST, H), np.float32)
    n_slots = int(split.cut_ptr[-1])
    part = [None] * n_slots
    for i in range(len(split.item_row)):
        m = np.full(H, -1e30, np.float32)
        l = np.zeros(H, np.float32)
        acc = np.zeros((H, F), np.float32)
        for e in range(split.item_ptr[i], split.item_ptr[i + 1]):
            m, l, acc = _merge(m, l, acc, s[e], np.float32(1),
                               keep[e][:, None] * msg[e])
        row, slot = split.item_row[i], split.item_slot[i]
        if slot < 0:
            out[row] = acc * (np.float32(1) / np.maximum(
                l, np.float32(1e-16)))[:, None]
            m_out[row], l_out[row] = m, l
        else:
            part[slot] = (m, l, acc)
    for i, row in enumerate(split.cut_row):
        slots = part[split.cut_ptr[i]:split.cut_ptr[i + 1]]
        m = np.full(H, -1e30, np.float32)
        l = np.zeros(H, np.float32)
        acc = np.zeros((H, F), np.float32)
        for m_i, l_i, acc_i in slots:
            m, l, acc = _merge(m, l, acc, m_i, l_i, acc_i)
        assert (m == np.max([p[0] for p in slots], axis=0)).all()
        out[row] = acc * (np.float32(1) / np.maximum(
            l, np.float32(1e-16)))[:, None]
        m_out[row], l_out[row] = m, l
    return _round(out, tdt), m_out, l_out, split


def _xla(c, gather):
    """out (N, H, F), m and l (N, H) of the XLA composition in the caller's
    order, and the caller-order gradients of sum(out * g) in score, a_dst
    and msg."""
    src, dst, H = jnp.asarray(c["src"]), jnp.asarray(c["dst"]), c["H"]

    def fwd(score, a, msg):
        z = (score[src] if gather else score) + a[dst]
        z = jnp.where(z >= 0, z, SLOPE * z)
        alpha = jax_segment_softmax(z, dst, N_DST) * c["keep"]
        rows_msg = (msg[src] if gather else msg).reshape(len(c["src"]), H,
                                                         -1)
        out = jax_segment_sum(alpha[..., None] * rows_msg, dst, N_DST)
        m = jax.ops.segment_max(z, dst, N_DST)
        m = jnp.where(jnp.isfinite(m), m, -1e30)
        l = jax.ops.segment_sum(jnp.exp(z - m[dst]), dst, N_DST)
        return out, m, l

    args = tuple(jnp.asarray(c[n]) for n in ("score", "a", "msg"))
    (out, m, l), vjp = jax.vjp(fwd, *args)
    g = jnp.asarray(c["g"].reshape(N_DST, H, -1))
    grads = vjp((g, jnp.zeros_like(m), jnp.zeros_like(l)))
    return (np.asarray(out), np.asarray(m), np.asarray(l),
            [np.asarray(x) for x in grads])


def _pallas(c, gather, jdt):
    """out (N, H, F), m and l (N, H) of the Pallas `_flash_forward_mh` in
    interpret mode, on per-edge lanes in the JAX plan's padded order."""
    lanes = _JaxLanes(c)
    H, plan = c["H"], lanes.plan
    score = c["score"][c["src"]] if gather else c["score"]
    msg = c["msg"][c["src"]] if gather else c["msg"]
    out, m, l = _flash_forward_mh(
        lanes.pad(score), jnp.asarray(c["a"]),
        lanes.pad(msg.reshape(len(c["src"]), H, -1)).astype(jdt), plan,
        SLOPE, True, keep_pad=lanes.pad(c["keep"]))

    def rows(v):  # (H * nb, 1, R) -> (N, H)
        return np.asarray(v).reshape(H, -1)[:, :N_DST].T

    out = np.asarray(out[:, :N_DST].astype(jnp.float32)).transpose(1, 0, 2)
    return out, rows(m), rows(l)


def _close(got, want, rtol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _port_plain(c, gather, tdt):
    """The port's plain forward: (out, m, l) as numpy float32."""
    plan = c["plan"]
    keep = torch.from_numpy(c["keep"])
    if not gather:
        keep = keep[torch.from_numpy(plan.perm)]
    msg = torch.from_numpy(c["msg"])
    score = torch.from_numpy(c["score"])
    if not gather:
        perm = torch.from_numpy(plan.perm)
        msg, score = msg[perm], score[perm]
    out, m, l = k.flash_forward_reference(
        score, torch.from_numpy(c["a"]), msg.to(tdt), keep, plan, SLOPE,
        gather)
    return (out.float().numpy().reshape(N_DST, c["H"], -1), m.numpy(),
            l.numpy())


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,F", LAYOUTS)
def test_schedule_matches_plain_xla_and_pallas(H, F, dtype, gather):
    tdt, jdt = DTYPES[dtype]
    c = _case(H * 100 + F, H, F, tdt, gather)
    out, m, l, split = _schedule_forward(c, gather, tdt)
    # the star and the 2K row are cut (2K into exactly two items); the
    # rows of K and K + 1 edges are one and two items
    assert split.cut_row.tolist() == [0, 5, 7]
    assert np.diff(split.cut_ptr).tolist() == [-(-STAR // K), 2, 2]
    assert (split.item_row == 3).sum() == 1
    # the star's second item keeps nothing: its partial sums are 0
    lo = c["plan"].rowptr[0]
    assert split.item_ptr[1] - split.item_ptr[0] == K
    assert not c["keep"][c["plan"].perm[lo + K:lo + 2 * K]].any()
    empty = np.diff(c["plan"].rowptr) == 0
    assert empty.sum() > N_DST // 2
    assert (out[empty] == 0).all() and (m[empty] == -1e30).all()
    assert (l[empty] == 0).all()
    p_out, p_m, p_l = _port_plain(c, gather, tdt)
    x_out, x_m, x_l, _ = _xla(c, gather)
    j_out, j_m, j_l = _pallas(c, gather, jdt)
    np.testing.assert_array_equal(m, p_m)
    np.testing.assert_array_equal(m, x_m)
    np.testing.assert_array_equal(m, j_m)
    if dtype == "f32":
        for got, want in ((out, p_out), (l, p_l), (out, x_out), (l, x_l)):
            _close(got, want, 1e-5)
        for got, want in ((out, j_out), (l, j_l)):
            _close(got, want, 1e-4)
    else:  # against the f32 references of the same bf16 inputs
        _close(out, x_out, 2e-2)
        _close(l, x_l, 1e-5)
        _close(out, p_out, 2e-2)
        _close(out, j_out, 2e-2)


@pytest.mark.parametrize("Kx", [K, 700])
def test_schedule_does_not_depend_on_the_cut(Kx):
    """Cut at K (the star in 32 items) or at 700 (3 items), the folded
    row is the one-item walk's within f32 rounding; rows that are not cut
    are the same bits."""
    c = _case(5, 2, 8, torch.float32, True)
    out, m, l, split = _schedule_forward(c, True, torch.float32, Kx)
    whole, w_m, w_l, _ = _schedule_forward(c, True, torch.float32,
                                           10 ** 6)
    np.testing.assert_array_equal(m, w_m)
    _close(out, whole, 1e-5)
    _close(l, w_l, 1e-5)
    uncut = np.ones(N_DST, bool)
    uncut[split.cut_row] = False
    np.testing.assert_array_equal(out[uncut], whole[uncut])
    np.testing.assert_array_equal(l[uncut], w_l[uncut])


@pytest.mark.parametrize("gather", [False, True])
def test_schedule_without_edges(gather):
    none = np.zeros(0, np.int64)
    c = _case(9, 2, 8, torch.float32, gather, edges=(none, none))
    out, m, l, split = _schedule_forward(c, gather, torch.float32)
    assert len(split.item_row) == N_DST and len(split.cut_row) == 0
    assert (out == 0).all() and (m == -1e30).all() and (l == 0).all()
    p_out, p_m, p_l = _port_plain(c, gather, torch.float32)
    np.testing.assert_array_equal(out, p_out)
    np.testing.assert_array_equal(m, p_m)
    np.testing.assert_array_equal(l, p_l)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("H,F", LAYOUTS)
def test_folded_statistics_feed_the_backward_as_jax_vjp(H, F, gather):
    """The backward reads the forward's final m and l, which the fold
    writes for cut rows: the port's plain backward from the schedule's
    (out, m, l) against jax.vjp of the XLA composition, float32."""
    c = _case(H * 7 + F, H, F, torch.float32, gather)
    out, m, l, _ = _schedule_forward(c, gather, torch.float32)
    plan = c["plan"]
    perm = torch.from_numpy(plan.perm)
    score, msg = torch.from_numpy(c["score"]), torch.from_numpy(c["msg"])
    keep = torch.from_numpy(c["keep"])
    if not gather:
        score, msg, keep = score[perm], msg[perm], keep[perm]
    ds, dmsg, da = k.flash_backward_reference(
        score, torch.from_numpy(c["a"]), msg, keep, torch.from_numpy(m),
        torch.from_numpy(l), torch.from_numpy(out.reshape(N_DST, -1)),
        torch.from_numpy(c["g"]), plan, SLOPE, gather)
    ds, dmsg = ds.numpy(), dmsg.numpy()
    if gather:  # per-edge cotangents summed into their source rows
        d_score = np.zeros_like(c["score"])
        d_msg = np.zeros_like(c["msg"])
        np.add.at(d_score, plan.col, ds)
        np.add.at(d_msg, plan.col, dmsg)
    else:  # CSR order -> the caller's
        d_score, d_msg = np.empty_like(ds), np.empty_like(dmsg)
        d_score[plan.perm], d_msg[plan.perm] = ds, dmsg
    _, _, _, (w_score, w_a, w_msg) = _xla(c, gather)
    _close(d_score, w_score, 1e-5)
    _close(da.numpy(), w_a, 1e-5)
    _close(d_msg, w_msg, 1e-5)
