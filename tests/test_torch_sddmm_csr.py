"""The port's edge-endpoint ops (`expand_dst_csr`, `sddmm_csr`,
`sddmm_csr_mh`, `segment_sum_csr`, `gather_rows`) against the JAX package.

On the CPU each op runs its plain version. The same numpy inputs go
through the JAX Pallas ops (interpreted off-TPU) on plans built with
``window=False`` (padded lane order) and ``window=True`` (compact
dst-sorted order, the path of `_expand_kernel_win` and `segment_sum_win`),
and through XLA compositions. Every per-edge tensor, of either package, is
mapped to the caller's edge order before it is compared; cotangents are
drawn in the caller's order and mapped into each layout.

Tolerances: f32 1e-5 against XLA and 1e-4 against Pallas (bf16x3 products
that drop the lo*lo term); bf16 rtol 2e-2 against an f32 reference of the
same bf16 inputs. The unscaled expand is a copy, held exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import sddmm as jax_sddmm_coo
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import expand_dst_csr as jax_expand
from gammagl_tpu.ops.pallas import gather_rows as jax_gather_rows
from gammagl_tpu.ops.pallas import plan_gather_src_compact as jax_gather_compact
from gammagl_tpu.ops.pallas import sddmm_csr as jax_sddmm_csr
from gammagl_tpu.ops.pallas import sddmm_csr_mh as jax_sddmm_csr_mh
from gammagl_tpu.ops.pallas import segment_sum_csr as jax_segment_sum_csr
from gammagl_tpu.ops.pallas.segment_matmul import segment_sum_win

from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops import sddmm as port_sddmm_coo
from gammagl_tpu_torch.ops import sddmm_dot as port_sddmm_dot

WINDOW = [False, True]


def _graph(seed, n_dst=40, n_src=55, e=300):
    """N_src != N_dst; odd destination rows and the top half get no
    edges."""
    rng = np.random.default_rng(seed)
    dst = 2 * rng.integers(0, n_dst // 4, e)
    src = rng.integers(0, n_src, e)
    return src, dst, n_dst, n_src


class _Layouts:
    """One graph's plans in both packages and the maps between the
    caller's edge order and each package's per-edge order."""

    def __init__(self, src, dst, n_dst, n_src, window):
        self.src, self.dst, self.n_dst, self.n_src = src, dst, n_dst, n_src
        self.E = len(dst)
        self.window = window
        # small tiles, so the window plan shares boundary windows
        self.jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src, R=8,
                                        ET=32, window=window)
        self.plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
        self.order = np.argsort(dst, kind="stable")

    def to_lanes(self, vc, compact=False):
        """Caller order -> the JAX plan's lane order (pads 0), or its
        compact order (gather_len rows)."""
        vc = np.asarray(vc, np.float32)
        if compact:
            out = np.zeros((self.jplan.gather_len,) + vc.shape[1:],
                           np.float32)
            out[:self.E] = vc[self.order]
            return out
        valid = self.jplan.valid
        out = np.zeros((len(valid),) + vc.shape[1:], np.float32)
        out[valid] = vc[self.jplan.perm[valid]]
        return out

    def from_lanes(self, v, compact=False):
        v = np.asarray(v, np.float32)
        out = np.zeros((self.E,) + v.shape[1:], np.float32)
        if compact:
            out[self.order] = v[:self.E]
        else:
            valid = self.jplan.valid
            out[self.jplan.perm[valid]] = v[valid]
        return out

    def to_csr(self, vc):
        return torch.tensor(np.asarray(vc, np.float32)[self.plan.perm])

    def from_csr(self, v):
        out = np.zeros(v.shape, np.float32)
        out[self.plan.perm] = v.detach().float().numpy()
        return out


def _close(got, want, rtol):
    """|got - want| <= rtol*|want| + 1e-5*max|want|; the second term covers
    sums taken in different orders."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


def _star_graph(seed, n_dst=40, n_src=55, e=120, star=300):
    """A star of ``star`` edges into row 0 (a row the card's kernels cut
    into many work items at their item sizes) and ``e`` random edges into
    even rows below 20: odd rows and rows 20.. get none. Shuffled, so the
    CSR order is not the caller's."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([np.zeros(star, np.int64),
                          2 * rng.integers(0, n_dst // 4, e)])
    src = rng.integers(0, n_src, dst.shape[0])
    order = rng.permutation(dst.shape[0])
    return src[order], dst[order], n_dst, n_src


def _expand_vs_jax(lay, C, dtype, seed):
    """Forward: x_dst[dst_e], exact against the XLA gather and against
    the JAX kernel in bf16 (a one-hot product is a copy there), 1e-4 in
    f32. Backward: the per-edge segment sum, against the JAX VJP
    (`segment_sum_win` on window plans) and XLA's segment sum."""
    window = lay.window
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(lay.n_dst, C)).astype(np.float32)
    gc = rng.normal(size=(lay.E, C)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jplan = lay.jplan

    @jax.jit
    def ref(x, g):
        out, vjp = jax.vjp(lambda x: jax_expand(x, jplan, False, window), x)
        return out, vjp(g)[0]

    out_j, dx_j = ref(jnp.asarray(x, jdt),
                      jnp.asarray(lay.to_lanes(gc, window), jdt))
    tx = torch.tensor(x).to(tdt).requires_grad_()
    out = kops.expand_dst_csr(tx, lay.plan, interpret=True, compact=window)
    assert out.dtype == tdt and out.shape == (lay.E, C)
    (out.float() * lay.to_csr(gc).to(tdt).float()).sum().backward()
    x_in = tx.detach().float().numpy()
    np.testing.assert_array_equal(lay.from_csr(out), x_in[lay.dst])
    jout = lay.from_lanes(np.asarray(out_j, np.float32), window)
    dx_xla = np.asarray(jax.ops.segment_sum(
        jnp.asarray(np.asarray(torch.tensor(gc).to(tdt).float())),
        jnp.asarray(lay.dst), num_segments=lay.n_dst))
    if dtype == "bf16":  # the JAX bf16 backward adds tiles in bf16
        np.testing.assert_array_equal(lay.from_csr(out), jout)
        _close(tx.grad, dx_xla, 2e-2)
    else:
        _close(lay.from_csr(out), jout, 1e-4)
        _close(tx.grad, dx_xla, 1e-5)
        _close(tx.grad, dx_j, 1e-4)


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("C,dtype", [(7, "f32"), (40, "f32"), (40, "bf16"),
                                     (349, "f32"), (1, "f32"), (1, "bf16")])
def test_expand_dst_matches_jax(window, C, dtype):
    """`_expand_vs_jax` at GATv2's widths, RGCN's class width (C = 349:
    rows of 1396 bytes in f32, no multiple of 16) and one column."""
    _expand_vs_jax(_Layouts(*_graph(C), window), C, dtype, C + 1)


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("C,dtype", [(13, "f32"), (349, "f32"), (1, "bf16"),
                                     (40, "bf16")])
def test_expand_dst_star_matches_jax(window, C, dtype):
    """`_expand_vs_jax` on a graph with a 300-edge star row and rows
    without edges."""
    _expand_vs_jax(_Layouts(*_star_graph(C + 2), window), C, dtype, C + 3)


_GRAPHS = {"random": _graph, "star": _star_graph}


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("graph", sorted(_GRAPHS))
@pytest.mark.parametrize("weights", ["none", "edge", "head"])
@pytest.mark.parametrize("C,H,dtype", [(349, 1, "f32"), (1, 1, "f32"),
                                       (12, 4, "f32"), (40, 8, "bf16")])
def test_segment_sum_backward_matches_jax(window, graph, weights, C, H,
                                          dtype):
    """The backward of the per-edge segment sum, whose dv is the expand of
    the cotangent (scaled per edge, or per edge and head, by the weights):
    dv and dw against the VJP of the JAX package's `segment_sum_csr` (the
    weights multiplied in before it) and of an XLA composition. f32: 1e-5
    against XLA, 1e-4 against the JAX package; bf16 rtol 2e-2 against the
    f32 references of the same bf16 inputs (the port rounds the cotangent
    to v's dtype before its kernels read it, so the references read that
    rounded cotangent too)."""
    lay = _Layouts(*_GRAPHS[graph](C + 5), window)
    rng = np.random.default_rng(C + 6)
    E, Ep = lay.E, len(lay.jplan.valid)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    v = np.asarray(torch.tensor(rng.normal(size=(E, C)).astype(np.float32))
                   .to(tdt).float())
    w = {"none": None, "edge": rng.random(E).astype(np.float32),
         "head": rng.random((E, H)).astype(np.float32)}[weights]
    g = np.asarray(torch.tensor(rng.normal(size=(lay.n_dst, C)).astype(
        np.float32)).to(tdt).float())

    def weigh(v, w, n):
        if w is None:
            return v
        if w.ndim == 1:
            return v * w[:, None]
        return (v.reshape(n, w.shape[1], -1) * w[:, :, None]).reshape(n, C)

    def xla(v, w):
        return jax.ops.segment_sum(weigh(v, w, E), jnp.asarray(lay.dst),
                                   num_segments=lay.n_dst)

    def pallas(v, w):
        return jax_segment_sum_csr(weigh(v, w, Ep), lay.jplan)

    jw = None if w is None else jnp.asarray(w)
    jwl = None if w is None else jnp.asarray(lay.to_lanes(w))
    _, vjp_x = jax.vjp(lambda v: xla(v, jw), jnp.asarray(v))
    dv_x = vjp_x(jnp.asarray(g))[0]
    _, vjp_p = jax.vjp(lambda v: pallas(v, jwl),
                       jnp.asarray(lay.to_lanes(v)))
    dv_p = lay.from_lanes(vjp_p(jnp.asarray(g))[0])
    tv = lay.to_csr(v).to(tdt).requires_grad_()
    tw = None if w is None else lay.to_csr(w).requires_grad_()
    out = kops.segment_sum_csr(tv, lay.plan, tw)
    assert out.dtype == tdt
    (out.float() * torch.tensor(g)).sum().backward()
    assert tv.grad.dtype == tdt
    fine = dtype == "f32"
    _close(lay.from_csr(tv.grad), dv_x, 1e-5 if fine else 2e-2)
    _close(lay.from_csr(tv.grad), dv_p, 1e-4 if fine else 2e-2)
    if w is not None:
        dw_x = jax.grad(lambda w: jnp.sum(xla(jnp.asarray(v), w) * g))(jw)
        dw_p = lay.from_lanes(jax.grad(lambda w: jnp.sum(
            pallas(jnp.asarray(lay.to_lanes(v)), w) * g))(jwl))
        _close(lay.from_csr(tw.grad), dw_x, 1e-5 if fine else 2e-2)
        _close(lay.from_csr(tw.grad), dw_p, 1e-4 if fine else 2e-2)


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("graph", sorted(_GRAPHS))
@pytest.mark.parametrize("H,F", [(1, 349), (1, 1), (2, 6)])
def test_scaled_expand_matches_jax_backward_mh(window, graph, H, F):
    """The scaled expand (TPU row 7, `_sddmm_backward_mh`): the gradient of
    `sddmm_csr_mh` in its per-edge rows, g[e, h] * x_dst[row(e)], against
    the JAX package's (its Pallas kernel, interpreted) at 1e-4 and an XLA
    composition at 1e-5, f32."""
    lay = _Layouts(*_GRAPHS[graph](H * F + 7), window)
    rng = np.random.default_rng(H * F + 8)
    msg = rng.normal(size=(lay.E, H, F)).astype(np.float32)
    xd = rng.normal(size=(lay.n_dst, H, F)).astype(np.float32)
    gc = rng.normal(size=(lay.E, H)).astype(np.float32)
    jplan = lay.jplan

    @jax.jit
    def ref(m, xd, g):
        _, vjp = jax.vjp(
            lambda m: jax_sddmm_csr_mh(None, xd, jplan, msg=m), m)
        return vjp(g)[0]

    dm_j = lay.from_lanes(ref(jnp.asarray(lay.to_lanes(msg)),
                              jnp.asarray(xd),
                              jnp.asarray(lay.to_lanes(gc))))
    dm_x = gc[:, :, None] * xd[lay.dst]
    tm = lay.to_csr(msg).requires_grad_()
    out = kops.sddmm_csr_mh(None, torch.tensor(xd), lay.plan, msg=tm)
    (out * lay.to_csr(gc)).sum().backward()
    _close(lay.from_csr(tm.grad), dm_x, 1e-5)
    _close(lay.from_csr(tm.grad), dm_j, 1e-4)


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("weights", ["none", "edge", "head"])
def test_segment_sum_matches_jax(window, weights):
    """Per-edge rows summed into destinations: against the JAX kernels
    (`segment_sum_csr` on padded plans, `segment_sum_win` on window
    plans, which take no per-head weights) and an XLA composition,
    forward and the gradients of v and w."""
    lay = _Layouts(*_graph(21), window)
    H, C = 2, 6
    rng = np.random.default_rng(22)
    v = rng.normal(size=(lay.E, C)).astype(np.float32)
    w = {"none": None, "edge": rng.random(lay.E).astype(np.float32),
         "head": rng.random((lay.E, H)).astype(np.float32)}[weights]
    g = rng.normal(size=(lay.n_dst, C)).astype(np.float32)
    dst = jnp.asarray(lay.dst)

    def xla(v, w):
        vw = v
        if w is not None:
            vw = (v.reshape(lay.E, w.shape[1] if w.ndim == 2 else 1, -1)
                  * w.reshape(lay.E, -1, 1)).reshape(lay.E, C)
        return jax.ops.segment_sum(vw, dst, num_segments=lay.n_dst)

    jw = None if w is None else jnp.asarray(w)
    want, vjp = jax.vjp(lambda v: xla(v, jw), jnp.asarray(v))
    want_dv = vjp(jnp.asarray(g))[0]
    tv = lay.to_csr(v).requires_grad_()
    tw = None if w is None else lay.to_csr(w).requires_grad_()
    out = kops.segment_sum_csr(tv, lay.plan, tw)
    (out * torch.tensor(g)).sum().backward()
    _close(out, want, 1e-5)
    _close(lay.from_csr(tv.grad), want_dv, 1e-5)
    if w is not None:
        want_dw = jax.grad(lambda w: jnp.sum(xla(jnp.asarray(v), w)
                                             * g))(jnp.asarray(w))
        _close(lay.from_csr(tw.grad), want_dw, 1e-5)
    if weights != "head":  # the JAX kernels, 1-D lane weights
        wl = np.ones(lay.E, np.float32) if w is None else w
        if window:
            pallas = segment_sum_win(
                jnp.asarray(lay.to_lanes(v, True)),
                jnp.asarray(lay.to_lanes(wl)), lay.jplan)[:lay.n_dst]
        else:
            pallas = jax_segment_sum_csr(
                jnp.asarray(lay.to_lanes(v * wl[:, None])), lay.jplan)
        _close(out, pallas, 1e-4)


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("mode", ["gather", "msg", "mh"])
def test_sddmm_matches_jax(window, mode):
    """Scores and both gradients, f32: source rows gathered in the op
    (``gather``), per-edge rows from `gather_rows` (``msg``, whose
    backward is the SpMM), and multi-head."""
    lay = _Layouts(*_graph(31), window)
    H, F = (2, 4) if mode == "mh" else (1, 7)
    rng = np.random.default_rng(32)
    xs = rng.normal(size=(lay.n_src, H, F)).astype(np.float32)
    xd = rng.normal(size=(lay.n_dst, H, F)).astype(np.float32)
    gc = rng.normal(size=(lay.E, H)).astype(np.float32)
    jplan, plan = lay.jplan, lay.plan

    def jax_op(xs, xd):
        if mode == "mh":
            return jax_sddmm_csr_mh(xs, xd, jplan)
        if mode == "msg":
            msg = jax_gather_rows(xs[:, 0], jplan, "src")
            return jax_sddmm_csr(None, xd[:, 0], jplan, msg=msg)[:, None]
        return jax_sddmm_csr(xs[:, 0], xd[:, 0], jplan)[:, None]

    def port_op(xs, xd):
        if mode == "mh":
            return kops.sddmm_csr_mh(xs, xd, plan)
        if mode == "msg":
            msg = kops.gather_rows(xs[:, 0], plan, "src")
            return kops.sddmm_csr(None, xd[:, 0], plan, msg=msg)[:, None]
        return kops.sddmm_csr(xs[:, 0], xd[:, 0], plan)[:, None]

    @jax.jit
    def ref(xs, xd, g):
        out, vjp = jax.vjp(jax_op, xs, xd)
        return (out,) + vjp(g)

    def xla(xs, xd):
        return jax_sddmm_coo(jnp.asarray(np.stack([lay.src, lay.dst])),
                             xs, xd, "dot")

    out_j, dxs_j, dxd_j = ref(jnp.asarray(xs), jnp.asarray(xd),
                              jnp.asarray(lay.to_lanes(gc)))
    want, vjp = jax.vjp(xla, jnp.asarray(xs), jnp.asarray(xd))
    dxs_x, dxd_x = vjp(jnp.asarray(gc))
    txs = torch.tensor(xs, requires_grad=True)
    txd = torch.tensor(xd, requires_grad=True)
    out = port_op(txs, txd)
    assert out.dtype == torch.float32 and out.shape == (lay.E, H)
    (out * lay.to_csr(gc)).sum().backward()
    _close(lay.from_csr(out), want, 1e-5)
    _close(lay.from_csr(out), lay.from_lanes(out_j), 1e-4)
    for got, x_ref, p_ref in ((txs.grad, dxs_x, dxs_j),
                              (txd.grad, dxd_x, dxd_j)):
        _close(got, x_ref, 1e-5)
        _close(got, p_ref, 1e-4)


@pytest.mark.parametrize("window", WINDOW)
def test_sddmm_bf16_packed_path_matches_jax(window):
    """bf16 at F = 256: the JAX package takes its packed fused kernel
    (`_sddmm_fused_forward`, backward two SpMMs). The port's scores are
    f32 dots of the bf16 inputs (1e-5 against the f32 reference of the
    same inputs), its gradients bf16 rounded once (2e-2)."""
    lay = _Layouts(*_graph(41, e=200), window)
    rng = np.random.default_rng(42)
    xs = torch.tensor(rng.normal(size=(lay.n_src, 256))).bfloat16()
    xd = torch.tensor(rng.normal(size=(lay.n_dst, 256))).bfloat16()
    gc = rng.normal(size=lay.E).astype(np.float32)
    f32 = [jnp.asarray(t.float().numpy()) for t in (xs, xd)]
    ei = jnp.asarray(np.stack([lay.src, lay.dst]))
    want, vjp = jax.vjp(lambda a, b: jax_sddmm_coo(ei, a, b, "dot"), *f32)
    dxs_x, dxd_x = vjp(jnp.asarray(gc))
    jplan = lay.jplan
    out_j = jax.jit(lambda a, b: jax_sddmm_csr(a, b, jplan))(
        *[jnp.asarray(f, jnp.bfloat16) for f in f32])
    txs, txd = xs.requires_grad_(), xd.requires_grad_()
    out = kops.sddmm_csr(txs, txd, lay.plan)
    (out * lay.to_csr(gc)).sum().backward()
    _close(lay.from_csr(out), want, 1e-5)
    _close(lay.from_csr(out), lay.from_lanes(out_j), 2e-2)
    assert txs.grad.dtype == torch.bfloat16
    _close(txs.grad, dxs_x, 2e-2)
    _close(txd.grad, dxd_x, 2e-2)


@pytest.mark.parametrize("window", WINDOW)
@pytest.mark.parametrize("kind", ["src", "dst"])
def test_gather_rows_matches_jax(window, kind):
    """Endpoint rows per edge and their gradients: the JAX `gather_rows`
    (padded lanes), or on window plans `plan_gather_src_compact` and the
    compact `expand_dst_csr`."""
    lay = _Layouts(*_graph(51), window)
    rng = np.random.default_rng(52)
    n = lay.n_src if kind == "src" else lay.n_dst
    x = rng.normal(size=(n, 3, 4)).astype(np.float32)
    gc = rng.normal(size=(lay.E, 3, 4)).astype(np.float32)
    jplan = lay.jplan

    def jax_op(x):  # the JAX kernels take (N, C) rows
        x2 = x.reshape(n, 12)
        if not window:
            out = jax_gather_rows(x2, jplan, kind)
        elif kind == "src":
            out = jax_gather_compact(x2, jplan)
        else:
            out = jax_expand(x2, jplan, False, True)
        return out.reshape(-1, 3, 4)

    @jax.jit
    def ref(x, g):
        out, vjp = jax.vjp(jax_op, x)
        return out, vjp(g)[0]

    out_j, dx_j = ref(jnp.asarray(x), jnp.asarray(lay.to_lanes(gc, window)))
    tx = torch.tensor(x, requires_grad=True)
    out = kops.gather_rows(tx, lay.plan, kind)
    assert out.shape == (lay.E, 3, 4)
    (out * lay.to_csr(gc)).sum().backward()
    idx = lay.src if kind == "src" else lay.dst
    np.testing.assert_array_equal(lay.from_csr(out), x[idx])
    _close(lay.from_csr(out), lay.from_lanes(out_j, window), 1e-4)
    want_dx = np.asarray(jax.ops.segment_sum(jnp.asarray(gc),
                                             jnp.asarray(idx),
                                             num_segments=n))
    _close(tx.grad, want_dx, 1e-5)
    _close(tx.grad, dx_j, 1e-4)


def test_plan_gathers_are_gather_rows():
    src, dst, n_dst, n_src = _graph(61, n_dst=30, n_src=30)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    x = torch.randn(30, 5)
    want_src = x[torch.from_numpy(src[plan.perm])]
    for fn in (kops.plan_gather_src, kops.plan_gather_src_compact):
        assert torch.equal(fn(x, plan), want_src)
    assert torch.equal(kops.plan_gather_dst(x, plan),
                       kops.expand_dst_csr(x, plan))


@pytest.mark.parametrize("op", ["expand", "segment_sum", "sddmm",
                                "sddmm_msg", "gather"])
def test_no_edges(op):
    """E = 0: empty per-edge outputs, zero sums and zero gradients."""
    none = np.zeros(0, np.int64)
    plan = kops.build_csr_plan(none, none, 9, num_src=4)
    xs = torch.randn(4, 2, 3, requires_grad=True)
    xd = torch.randn(9, 2, 3, requires_grad=True)
    v = torch.zeros(0, 6, requires_grad=True)
    out = {"expand": lambda: kops.expand_dst_csr(xd, plan),
           "segment_sum": lambda: kops.segment_sum_csr(v, plan),
           "sddmm": lambda: kops.sddmm_csr_mh(xs, xd, plan),
           "sddmm_msg": lambda: kops.sddmm_csr_mh(
               None, xd, plan, msg=v.view(0, 2, 3)),
           "gather": lambda: kops.gather_rows(xs, plan, "src")}[op]()
    want = {"segment_sum": (9, 6), "sddmm": (0, 2), "sddmm_msg": (0, 2),
            "expand": (0, 2, 3), "gather": (0, 2, 3)}[op]
    assert tuple(out.shape) == want and bool((out == 0).all())
    (out.sum() + 0 * xs.sum() + 0 * xd.sum() + 0 * v.sum()).backward()
    for t in (xs, xd, v):
        assert bool((t.grad == 0).all())


@pytest.mark.parametrize("op", ["expand", "segment_sum", "sddmm",
                                "sddmm_msg", "gather"])
def test_create_graph_raises(op):
    """The kernels have no backward of their own: a backward that would
    build a graph for second derivatives raises, on the CPU as on the
    card."""
    src, dst, n_dst, n_src = _graph(71)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    xs = torch.randn(n_src, 4, requires_grad=True)
    xd = torch.randn(n_dst, 4, requires_grad=True)
    w = torch.rand(len(dst), requires_grad=True)
    out = {"expand": lambda: kops.expand_dst_csr(xd, plan),
           "segment_sum": lambda: kops.segment_sum_csr(
               kops.gather_rows(xs, plan), plan, w),
           "sddmm": lambda: kops.sddmm_csr(xs, xd, plan),
           "sddmm_msg": lambda: kops.sddmm_csr(
               None, xd, plan, msg=kops.gather_rows(xs, plan)),
           "gather": lambda: kops.gather_rows(xs, plan)}[op]()
    loss = (out ** 2).sum()
    inputs = [xd] if op == "expand" else [xs]
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, inputs, create_graph=True)
    grads = torch.autograd.grad(loss, inputs)  # first order still works
    assert grads[0].shape == inputs[0].shape


def test_wrappers_check_shapes():
    plan = kops.build_csr_plan([0, 1, 2], [1, 2, 0], 3)
    with pytest.raises(ValueError, match="rows"):
        kops.expand_dst_csr(torch.ones(2, 4), plan)
    with pytest.raises(ValueError, match="E=3"):
        kops.segment_sum_csr(torch.ones(4, 4), plan)
    with pytest.raises(ValueError, match="H dividing"):
        kops.segment_sum_csr(torch.ones(3, 4), plan, torch.ones(3, 3))
    with pytest.raises(ValueError, match="differ"):
        kops.sddmm_csr(torch.ones(3, 4), torch.ones(3, 5), plan)
    with pytest.raises(ValueError, match="index_kind"):
        kops.gather_rows(torch.ones(3, 4), plan, "edge")


@pytest.mark.parametrize("op", ["dot", "add", "mul", "sub"])
def test_coo_sddmm_matches_jax(op):
    src, dst, n_dst, n_src = _graph(81, n_dst=30, n_src=30)
    ei = np.stack([src, dst])
    rng = np.random.default_rng(82)
    xs = rng.normal(size=(30, 2, 5)).astype(np.float32)
    xd = rng.normal(size=(30, 2, 5)).astype(np.float32)
    want = jax_sddmm_coo(jnp.asarray(ei), jnp.asarray(xs), jnp.asarray(xd),
                         op)
    got = port_sddmm_coo(torch.tensor(ei), torch.tensor(xs),
                         torch.tensor(xd), op)
    _close(got, want, 1e-6)
    if op == "dot":
        _close(port_sddmm_dot(torch.tensor(ei), torch.tensor(xs),
                              torch.tensor(xd)), want, 1e-6)
    with pytest.raises(ValueError, match="unknown op"):
        port_sddmm_coo(torch.tensor(ei), torch.tensor(xs), torch.tensor(xd),
                       "max")
