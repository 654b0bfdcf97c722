"""The port's fused edge attention (gammagl_tpu_torch.ops.cuda.flash_attention)
against the JAX package.

On the CPU the port runs its plain versions. The same numpy inputs, in
the caller's edge order, go through the JAX `flash_edge_attention_mh`
(the Pallas kernels, which interpret themselves off-TPU, in the plan's
padded lane order) and through an XLA composition of the JAX
`segment_softmax` and `segment_sum`. Per-edge tensors are carried into
each plan's order through its perm and back, so functions are compared,
never layouts.

Tolerances, |port - ref| <= rtol*|ref| + atol*max|ref|: f32 against XLA
rtol 1e-5, atol 1e-5 (sums in other orders); against Pallas rtol 1e-4,
atol 1e-4 (its f32 products are bf16x3 splits without the lo*lo term,
flash_attention.py:213-222). bf16 against an f32 reference of the same
bf16 inputs: rtol 2e-2, atol 2e-2.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import segment_softmax as jax_segment_softmax
from gammagl_tpu.ops import bspmm as jax_bspmm
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import flash_edge_attention as jax_flash_1h
from gammagl_tpu.ops.pallas import flash_edge_attention_mh as jax_flash_mh
from gammagl_tpu.ops.pallas import flash_softmax_spmm as jax_softmax_spmm
from gammagl_tpu.ops.segment import segment_sum as jax_segment_sum

from gammagl_tpu_torch.ops import bspmm, segment_softmax
from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops.cuda import _build

SLOPE = 0.2


def _close(got, want, rtol, atol):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _case(seed, n_dst=40, n_src=None, e=200, H=2, F=8, empty_rows=False):
    """Edges, per-edge scores, messages and keep in the caller's order."""
    rng = np.random.default_rng(seed)
    n_src = n_dst if n_src is None else n_src
    dst = rng.integers(0, n_dst, e)
    if empty_rows:  # odd rows and the top quarter get no edges
        dst = 2 * (dst * 3 // 8)
    src = rng.integers(0, n_src, e)
    return dict(
        src=src, dst=dst, n_dst=n_dst, n_src=n_src, H=H, F=F,
        s=rng.normal(size=(e, H)).astype(np.float32),
        a=rng.normal(size=(n_dst, H)).astype(np.float32),
        msg=rng.normal(size=(e, H, F)).astype(np.float32),
        keep=(rng.random((e, H)) < 0.6).astype(np.float32) / 0.6,
        g=rng.normal(size=(n_dst, H, F)).astype(np.float32))


class _JaxLanes:
    """Caller order <-> the JAX plan's padded lane order."""

    def __init__(self, c):
        self.plan = jax_build_csr_plan(c["src"], c["dst"], c["n_dst"],
                                       num_src=c["n_src"], R=8, ET=16)
        self.valid = self.plan.valid
        self.perm = np.where(self.valid, self.plan.perm, 0)

    def pad(self, a):
        out = np.asarray(a)[self.perm]
        return jnp.asarray(out * self.valid.reshape(
            (-1,) + (1,) * (out.ndim - 1)))

    def unpad(self, a, e):
        out = np.zeros((e,) + np.asarray(a).shape[1:], np.float32)
        out[self.plan.perm[self.valid]] = np.asarray(a)[self.valid]
        return out


def _jax_pallas(c, keep):
    """out and the caller-order gradients of sum(out * g) from the Pallas
    path."""
    lanes = _JaxLanes(c)
    kp = lanes.pad(c["keep"]) if keep else None

    def loss(s, a, msg):
        out = jax_flash_mh(s, a, msg, lanes.plan, SLOPE, keep_pad=kp)
        return jnp.sum(out * c["g"]), out

    (_, out), gr = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        lanes.pad(c["s"]), jnp.asarray(c["a"]), lanes.pad(c["msg"]))
    e = len(c["src"])
    return out, (lanes.unpad(gr[0], e), gr[1], lanes.unpad(gr[2], e))


def _jax_xla(c, keep):
    """The same function composed of XLA ops in the caller's edge order."""
    dst = jnp.asarray(c["dst"])

    def loss(s, a, msg):
        z = s + a[dst]
        z = jnp.where(z >= 0, z, SLOPE * z)
        alpha = jax_segment_softmax(z, dst, c["n_dst"])
        if keep:
            alpha = alpha * c["keep"]
        out = jax_segment_sum(alpha[..., None] * msg, dst, c["n_dst"])
        return jnp.sum(out * c["g"]), out

    (_, out), gr = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(c["s"]), jnp.asarray(c["a"]), jnp.asarray(c["msg"]))
    return out, gr


def _port(c, keep, dtype=torch.float32):
    """out and caller-order gradients from the port's per-edge entry."""
    plan = kops.build_csr_plan(c["src"], c["dst"], c["n_dst"],
                               num_src=c["n_src"])
    perm = torch.from_numpy(plan.perm)
    s = torch.tensor(c["s"])[perm].requires_grad_()
    a = torch.tensor(c["a"]).requires_grad_()
    msg = torch.tensor(c["msg"])[perm].to(dtype).requires_grad_()
    kp = torch.tensor(c["keep"])[perm] if keep else None
    out = kops.flash_edge_attention_mh(s, a, msg, plan, SLOPE, keep=kp)
    (out.float() * torch.tensor(c["g"])).sum().backward()
    back = torch.empty_like(perm)
    back[perm] = torch.arange(len(perm))
    return out, (s.grad[back], a.grad, msg.grad.float()[back])


@pytest.mark.parametrize("H,F", [(1, 8), (2, 4), (2, 16)])
@pytest.mark.parametrize("keep", [False, True])
def test_forward_and_gradients_match_jax(H, F, keep):
    c = _case(H * 100 + F, H=H, F=F)
    got, got_g = _port(c, keep)
    assert got.shape == (c["n_dst"], H, F)
    want, want_g = _jax_xla(c, keep)
    _close(got, want, 1e-5, 1e-5)
    for a, b in zip(got_g, want_g):
        _close(a, b, 1e-5, 1e-5)
    want, want_g = _jax_pallas(c, keep)
    _close(got, want, 1e-4, 1e-4)
    for a, b in zip(got_g, want_g):
        _close(a, b, 1e-4, 1e-4)


def _bwd_groups(H, F, itemsize):
    """Edges a warp of csrc/flash_attention.cu's backward takes at once
    (its pick_bwd_layout): a lane loads V columns (the widest of 16 bytes
    that divides F), a head takes Lh lanes (the power of two >= F / V, at
    most 32), an edge the lanes of as many heads as fit 32 (a power of
    two); 32 over that is the warp's groups."""
    v = 16 // itemsize
    while F % v:
        v //= 2
    lanes_head = 1
    while lanes_head < 32 and lanes_head < F // v:
        lanes_head *= 2
    heads = 1
    while heads * lanes_head < 32 and heads < H:
        heads *= 2
    return 32 // (heads * lanes_head)


@pytest.mark.parametrize("H,F,itemsize,groups", [
    (8, 8, 2, 4), (1, 40, 2, 4), (4, 64, 2, 1), (2, 640, 2, 1),
    (8, 8, 4, 2), (1, 40, 4, 2)])
@pytest.mark.parametrize("keep", [False, True])
def test_backward_group_order_of_da_matches_jax(H, F, itemsize, groups,
                                               keep):
    """da_dst as the backward kernel adds it: group q of a row's warp takes
    the row's edges q, q + groups, ... and sums their ds per head in turn;
    the groups' partials are added in group order. Emulated in numpy
    float32 on the plain version's ds, it matches the plain version's da
    and jax.grad of the XLA composition at 1e-5, on rows of no edges and
    of dozens."""
    assert _bwd_groups(H, F, itemsize) == groups
    c = _case(H * 1000 + F, n_dst=24, e=500, H=H, F=F, empty_rows=True)
    plan = kops.build_csr_plan(c["src"], c["dst"], c["n_dst"],
                               num_src=c["n_src"])
    perm = torch.from_numpy(plan.perm)
    s, msg = torch.tensor(c["s"])[perm], torch.tensor(c["msg"])[perm]
    msg = msg.reshape(len(perm), H * F)
    a = torch.tensor(c["a"])
    kp = torch.tensor(c["keep"])[perm] if keep else None
    g = torch.tensor(c["g"]).reshape(c["n_dst"], H * F)
    out, m, l = kops.flash_forward_reference(s, a, msg, kp, plan, SLOPE,
                                             False)
    ds, _, da = kops.flash_backward_reference(s, a, msg, kp, m, l, out, g,
                                              plan, SLOPE, False)
    ds = ds.numpy()
    got = np.zeros((c["n_dst"], H), np.float32)
    for row in range(c["n_dst"]):
        lo, hi = plan.rowptr[row], plan.rowptr[row + 1]
        for q in range(groups):
            part = np.zeros(H, np.float32)
            for e in range(lo + q, hi, groups):
                part = part + ds[e]
            got[row] = got[row] + part
    _close(got, da, 1e-5, 1e-5)
    _, want_g = _jax_xla(c, keep)
    _close(got, want_g[1], 1e-5, 1e-5)


def test_isolated_rows_are_exact_zeros_and_src_count_differs():
    c = _case(5, n_dst=48, n_src=30, e=150, empty_rows=True)
    empty = np.bincount(c["dst"], minlength=c["n_dst"]) == 0
    assert empty.sum() > c["n_dst"] // 2
    got, (ds, da, dmsg) = _port(c, keep=True)
    assert bool((got[torch.from_numpy(empty)] == 0).all())
    assert bool((da[torch.from_numpy(empty)] == 0).all())
    want, want_g = _jax_pallas(c, keep=True)
    _close(got, want, 1e-4, 1e-4)
    _close(da, want_g[1], 1e-4, 1e-4)
    # the plain forward's statistics of an empty row are the JAX kernel's
    plan = kops.build_csr_plan(c["src"], c["dst"], c["n_dst"],
                               num_src=c["n_src"])
    perm = torch.from_numpy(plan.perm)
    _, m, l = kops.flash_forward_reference(
        torch.tensor(c["s"])[perm], torch.tensor(c["a"]),
        torch.tensor(c["msg"]).reshape(len(perm), -1)[perm], None, plan,
        SLOPE, False)
    assert bool((m[torch.from_numpy(empty)] == -1e30).all())
    assert bool((l[torch.from_numpy(empty)] == 0).all())


@pytest.mark.parametrize("gather", [False, True])
def test_no_edges(gather):
    none = np.zeros(0, np.int64)
    plan = kops.build_csr_plan(none, none, 9, num_src=4)
    rows = 4 if gather else 0
    s = torch.zeros(rows, 2, requires_grad=True)
    a = torch.randn(9, 2, requires_grad=True)
    x = torch.randn(rows, 2, 3, requires_grad=True)
    fn = kops.flash_gat_attention if gather else kops.flash_edge_attention_mh
    out = fn(s, a, x, plan)
    assert out.shape == (9, 2, 3) and bool((out == 0).all())
    out.sum().backward()
    assert bool((a.grad == 0).all()) and bool((x.grad == 0).all())
    assert s.grad.shape == (rows, 2)


def test_wide_head_against_the_jax_xla_fallback():
    """F = 640 a head: the JAX backward falls back to XLA above 512
    columns (flash_attention.py:851); the port's kernel takes any F."""
    c = _case(9, n_dst=12, e=48, H=2, F=640)
    got, got_g = _port(c, keep=True)
    want, want_g = _jax_pallas(c, keep=True)
    _close(got, want, 1e-4, 1e-4)
    for a, b in zip(got_g, want_g):
        _close(a, b, 1e-4, 1e-4)


@pytest.mark.parametrize("keep", [False, True])
def test_gather_entry_matches_per_edge_entry(keep):
    """flash_gat_attention reads node rows at each edge's source and keep
    in the caller's edge order; its gradients reach the source rows
    through spmm_csr on the plan's edge-scatter transpose."""
    rng = np.random.default_rng(11)
    n_dst, n_src, e, H, F = 30, 26, 160, 2, 8
    src, dst = rng.integers(0, n_src, e), rng.integers(0, n_dst, e)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    col = torch.from_numpy(plan.col).long()
    s_node = torch.randn(n_src, H, dtype=torch.float64).float()
    x_node = torch.randn(n_src, H, F)
    a = torch.randn(n_dst, H)
    kp = (torch.rand(e, H) < 0.5).float() * 2 if keep else None
    g = torch.randn(n_dst, H, F)
    leaves = [t.clone().requires_grad_() for t in (s_node, x_node, a)]
    out = kops.flash_gat_attention(leaves[0], leaves[2], leaves[1], plan,
                                   keep=kp)
    (out * g).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in (s_node, x_node, a)]
    kp_csr = kp[torch.from_numpy(plan.perm)] if keep else None
    ref = kops.flash_edge_attention_mh(ref_leaves[0][col], ref_leaves[2],
                                       ref_leaves[1][col], plan, keep=kp_csr)
    (ref * g).sum().backward()
    _close(out, ref.detach(), 1e-6, 1e-6)
    for got, want in zip(leaves, ref_leaves):
        _close(got.grad, want.grad, 1e-5, 1e-5)


@pytest.mark.parametrize("gather", [False, True])
def test_create_graph_raises(gather):
    """The kernels have no backward of their own: a backward that would
    build a graph for second derivatives raises, on the CPU as on the
    card, for per-edge and gathered inputs."""
    plan = kops.build_csr_plan([0, 1, 2, 2], [1, 2, 0, 1], 3)
    rows = 3 if gather else 4
    s = torch.randn(rows, 2, requires_grad=True)
    a = torch.randn(3, 2, requires_grad=True)
    x = torch.randn(rows, 2, 4, requires_grad=True)
    fn = kops.flash_gat_attention if gather else kops.flash_edge_attention_mh
    loss = (fn(s, a, x, plan) ** 2).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, (s, a, x), create_graph=True)
    assert all(g.shape == t.shape for g, t in zip(
        torch.autograd.grad(loss, (s, a, x)), (s, a, x)))


def test_single_head_and_arbitrary_score_wrappers():
    c = _case(13, H=1, F=8)
    lanes = _JaxLanes(c)
    plan = kops.build_csr_plan(c["src"], c["dst"], c["n_dst"])
    perm = torch.from_numpy(plan.perm)
    s = torch.tensor(c["s"][:, 0])[perm]
    msg = torch.tensor(c["msg"][:, 0])[perm]
    kp = torch.tensor(c["keep"][:, 0])[perm]
    got = kops.flash_edge_attention(s, torch.tensor(c["a"][:, 0]), msg,
                                    plan, SLOPE, keep=kp)
    want = jax_flash_1h(lanes.pad(c["s"][:, 0]), jnp.asarray(c["a"][:, 0]),
                        lanes.pad(c["msg"][:, 0]), lanes.plan, SLOPE,
                        keep_pad=lanes.pad(c["keep"][:, 0]))
    _close(got, want, 1e-4, 1e-4)
    got = kops.flash_softmax_spmm(s, msg, plan)
    want = jax_softmax_spmm(lanes.pad(c["s"][:, 0]),
                            lanes.pad(c["msg"][:, 0]), lanes.plan)
    _close(got, want, 1e-4, 1e-4)
    got = kops.flash_softmax_spmm_mh(s[:, None], msg[:, None], plan)
    _close(got[:, 0], want, 1e-4, 1e-4)


def test_bf16_within_rounding_of_f32_reference():
    c = _case(17, H=2, F=8)
    c["msg"] = torch.tensor(c["msg"]).bfloat16().float().numpy()
    got, got_g = _port(c, keep=True, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want, want_g = _jax_xla(c, keep=True)
    _close(got, want, 2e-2, 2e-2)
    for a, b in zip(got_g, want_g):
        _close(a, b, 2e-2, 2e-2)


def test_keep_mask_values_and_rate():
    gen = torch.Generator().manual_seed(0)
    keep = kops.attention_keep_mask(gen, 0.6, (20000, 2))
    assert keep.dtype == torch.float32 and keep.shape == (20000, 2)
    vals = torch.unique(keep)
    assert vals.tolist() == [0.0, pytest.approx(1 / 0.4)]
    assert abs(float((keep > 0).float().mean()) - 0.4) < 0.02
    again = kops.attention_keep_mask(torch.Generator().manual_seed(0), 0.6,
                                     (20000, 2))
    assert torch.equal(keep, again)


def test_keep_mask_is_drawn_where_its_generator_lives(monkeypatch):
    """``device=None`` means the generator's device; without a generator
    the current CUDA card, which raises without one rather than drawing on
    the CPU. A named device is used as given."""
    keep = kops.attention_keep_mask(torch.Generator().manual_seed(1), 0.5,
                                    (40, 2))
    assert keep.device.type == "cpu"
    assert kops.attention_keep_mask(None, 0.5, (3,), "cpu").device.type == (
        "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kops.attention_keep_mask(None, 0.5, (40, 2))


def test_segment_softmax_and_bspmm_match_jax():
    rng = np.random.default_rng(21)
    n, e, H, F = 20, 90, 2, 5
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 4, e)])
    z = rng.normal(size=(e, H)).astype(np.float32)
    x = rng.normal(size=(n, H, F)).astype(np.float32)
    alpha = segment_softmax(torch.tensor(z), torch.tensor(ei[1]), n)
    want = jax_segment_softmax(jnp.asarray(z), jnp.asarray(ei[1]), n)
    _close(alpha, want, 1e-6, 1e-6)
    got = bspmm(torch.tensor(ei), alpha, torch.tensor(x), num_nodes=n)
    want = jax_bspmm(jnp.asarray(ei), want, jnp.asarray(x), num_nodes=n)
    _close(got, want, 1e-5, 1e-5)
    assert bool((got[n - 4:] == 0).all())


def test_cpu_path_neither_builds_nor_counts():
    c = _case(23)
    before = (kops.flash_forward.launches, kops.flash_backward.launches)
    misses = _build.load_library.cache_info().misses
    _port(c, keep=False)
    assert (kops.flash_forward.launches,
            kops.flash_backward.launches) == before
    assert _build.load_library.cache_info().misses == misses


def test_wrapper_checks_inputs():
    plan = kops.build_csr_plan([0, 1, 2], [1, 2, 0], 3)
    s, a, x = torch.zeros(3, 2), torch.zeros(3, 2), torch.zeros(3, 2, 4)
    with pytest.raises(ValueError, match="edges"):
        kops.flash_edge_attention_mh(s[:2], a, x[:2], plan)
    with pytest.raises(ValueError, match="a_dst shape"):
        kops.flash_edge_attention_mh(s, a[:, :1], x, plan)
    with pytest.raises(ValueError, match="keep shape"):
        kops.flash_edge_attention_mh(s, a, x, plan, keep=torch.ones(3, 1))
    with pytest.raises(ValueError, match="rows, the plan reads"):
        kops.flash_gat_attention(s[:2], a, x[:2], plan)
    with pytest.raises(ValueError, match="no kernel"):
        kops.flash_edge_attention_mh(s.to("meta"), a.to("meta"),
                                     x.to("meta"), plan)


@pytest.mark.parametrize("H,F,e", [(8, 4, 240), (1, 40, 240), (2, 8, 0)])
def test_gathered_score_gradient_matches_jax_c39(H, F, e, monkeypatch):
    """ROADMAP C39: the gathered backward sums the score's per-edge
    gradients into their source rows with `spmm_csr` on the plan's
    edge-scatter transpose (no atomic add on the card), as it sums the
    features'. On node rows with 3 rows past the plan's sources (they get
    zero rows), at H = 8, H = 1 and on a plan with no edges: the output
    and the gradients of the score, the destination score and the
    features against the JAX package's XLA composition (gather,
    `segment_softmax`, `segment_sum`), f32 at 1e-5. The backward takes
    exactly two `spmm_csr` calls, both on the edge-scatter plan."""
    from gammagl_tpu_torch.ops.cuda import flash_attention as fa
    rng = np.random.default_rng(31 + H + e)
    n_dst, n_src, extra = 30, 26, 3
    src, dst = rng.integers(0, n_src, e), rng.integers(0, n_dst, e)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    s_node = rng.normal(size=(n_src + extra, H)).astype(np.float32)
    x_node = rng.normal(size=(n_src + extra, H, F)).astype(np.float32)
    a = rng.normal(size=(n_dst, H)).astype(np.float32)
    keep = (rng.random((e, H)) < 0.6).astype(np.float32) / 0.6
    g = rng.normal(size=(n_dst, H, F)).astype(np.float32)

    calls = []

    def counted(x, w, p, *args, **kw):
        calls.append(p)
        return kops.spmm_csr(x, w, p, *args, **kw)

    monkeypatch.setattr(fa, "spmm_csr", counted)
    leaves = [torch.tensor(t, requires_grad=True) for t in (s_node, a,
                                                             x_node)]
    out = kops.flash_gat_attention(leaves[0], leaves[1], leaves[2], plan,
                                   SLOPE, keep=torch.tensor(keep))
    (out * torch.tensor(g)).sum().backward()
    assert len(calls) == 2 and all(p is plan.edge_scatter_plan()
                                   for p in calls)

    jsrc, jdst = jnp.asarray(src), jnp.asarray(dst)

    def loss(s, a_, x):
        z = s[jsrc] + a_[jdst]
        z = jnp.where(z >= 0, z, SLOPE * z)
        alpha = jax_segment_softmax(z, jdst, n_dst) * keep
        o = jax_segment_sum(alpha[..., None] * x[jsrc], jdst, n_dst)
        return jnp.sum(o * g), o

    (_, want), want_g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(s_node, a, x_node)
    _close(out, want, 1e-5, 1e-5)
    for leaf, wg in zip(leaves, want_g):
        _close(leaf.grad, wg, 1e-5, 1e-5)
    assert not leaves[0].grad[n_src:].any()
    assert not leaves[2].grad[n_src:].any()
