"""The port's block-pair SpMM (gammagl_tpu_torch.ops.cuda.block_pair)
against the JAX package.

On the CPU `spmm_block_pair` runs its plain version; the same numpy
inputs go through JAX `spmm_block_pair` (the Pallas kernel, which
interprets itself off-TPU) and JAX `ops.spmm` (XLA). The plans are built
by both packages from the same edges; their public sizes must agree, their
layouts need not.

Tolerances: f32 1e-5 against XLA, 1e-4 against Pallas, whose f32 path is a
bf16 hi/lo split that drops the lo*lo term (block_pair.py:164-181). bf16
rtol 2e-2 against an f32 reference of the same bf16 inputs: the JAX bf16
path rounds each message and weight to bf16, the port rounds once.
"""

import functools
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.ops import spmm as jax_spmm
from gammagl_tpu.ops.pallas import build_block_pair_plan as jax_build
from gammagl_tpu.ops.pallas import build_hybrid_plan as jax_build_hybrid
from gammagl_tpu.ops.pallas import spmm_block_pair as jax_spmm_block_pair
from gammagl_tpu.ops.pallas import spmm_hybrid as jax_spmm_hybrid

from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops.cuda import _build


def _case(seed=0, n=40, e=200, f=8, band=None, n_src=None):
    rng = np.random.default_rng(seed)
    n_src = n if n_src is None else n_src
    dst = rng.integers(0, n, e)
    if band:
        src = np.clip(dst + rng.integers(-band, band, e), 0, n_src - 1)
    else:
        src = rng.integers(0, n_src, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    return src, dst, w, x


def _close(got, want, rtol):
    """|got - want| <= rtol*|want| + rtol*max|want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


PLANS = {  # name -> (case kwargs, n_dst, tiling)
    "random": (dict(seed=0), 40, dict(R=8, S=8, ET=16)),
    "banded": (dict(seed=4, band=4), 40, dict(R=8, S=8, ET=8)),
    "rect": (dict(seed=1, n=20, n_src=30, e=120), 20, dict(R=8, S=8, ET=16)),
    "wide": (dict(seed=6, n=300, e=3000, band=20), 300,
             dict(R=64, S=32, ET=128)),
    "empty blocks": (dict(seed=7, n=10, n_src=70, e=50), 70,
                     dict(R=8, S=16, ET=16)),
    "R=S=256": (dict(seed=8, n=700, n_src=600, e=6000, band=40), 700,
                dict(R=256, S=256, ET=256)),
    "no edges": (dict(seed=9, n=20, n_src=12, e=0), 20,
                 dict(R=8, S=8, ET=16)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_sizes_match_jax(name):
    kw, n_dst, tiling = PLANS[name]
    src, dst, _, x = _case(**kw)
    n_src = x.shape[0]
    want = jax_build(src, dst, n_dst, num_src=n_src, **tiling)
    got = kops.build_block_pair_plan(src, dst, n_dst, num_src=n_src,
                                     **tiling)
    for attr in ("num_nodes", "num_src", "num_edges", "R", "S", "ET",
                 "E_pad", "T", "nblocks", "n_src_blocks", "fill_ratio"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.perm_nodes is None and want.perm_nodes is None
    assert repr(got) == repr(want)


def test_reordered_plan_matches_jax():
    src, dst, _, _ = _case(seed=3, n=32, e=150, band=6)
    want = jax_build(src, dst, 32, R=8, S=8, ET=16, reorder=True)
    got = kops.build_block_pair_plan(src, dst, 32, R=8, S=8, ET=16,
                                     reorder=True)
    np.testing.assert_array_equal(got.perm_nodes, want.perm_nodes)
    assert (got.E_pad, got.T, got.fill_ratio) == (want.E_pad, want.T,
                                                  want.fill_ratio)


def _kernel_constants():
    """kRowsPerGroup, kMaxGroups and kWeightsAhead of csrc/block_pair.cu:
    the emulation below follows the kernel's own schedule (a step holds
    kMaxGroups * L * kWeightsAhead edges)."""
    src = (_build.CSRC_DIR / "block_pair.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1))
                 for name in ("kRowsPerGroup", "kMaxGroups", "kWeightsAhead"))


def _lanes(F, itemsize=4):
    """The kernel's lanes a group: the fewest of 4, 8 or 16 whose 16-byte
    loads cover F (shared memory allows 16 at S = 256)."""
    lanes = 4
    while lanes < 16 and lanes * 16 // itemsize < F:
        lanes *= 2
    return lanes


def _emulate_forward(plan, x, w, edge_chunk=None, itemsize=4):
    """The forward as block_pair_fwd_kernel schedules it, in numpy float32:
    a CTA per (destination block, column chunk of FT = 16 L bytes), steps
    of at most ``edge_chunk`` edges of one pair with the pair's slab (rows
    past N_src not staged; None: the kernel's step), each lane group's
    kRowsPerGroup rows found through row_ptr and summed in the step's edge
    order. Asserts what the kernel relies on and that every edge is summed
    once per chunk."""
    rows_per_group, max_groups, ahead = _kernel_constants()
    R, S, F = plan.R, plan.S, x.shape[1]
    assert R <= rows_per_group * max_groups
    lanes = _lanes(F, itemsize)
    ft = lanes * 16 // itemsize
    if edge_chunk is None:
        edge_chunk = max_groups * lanes * ahead
    rp = plan.row_ptr.astype(np.int64)
    assert plan.row_ptr.dtype == np.int32
    assert rp.shape == (plan.pair_src.shape[0] * R + 1,) and rp[0] == 0
    assert rp[-1] == plan.num_plan_edges and (np.diff(rp) >= 0).all()
    xf = np.asarray(x, np.float32)
    wts = (np.ones(plan.num_plan_edges, np.float32) if w is None
           else np.asarray(w, np.float32)[plan.w_perm])
    out = np.zeros((plan.num_nodes, F), np.float32)
    visits = np.zeros(plan.num_plan_edges, np.int64)
    for b in range(plan.nblocks):
        nrows = min(R, plan.num_nodes - b * R)
        for c0 in range(0, F, ft):
            cols = slice(c0, min(c0 + ft, F))
            acc = np.zeros((R, cols.stop - c0), np.float32)
            p, p_end = int(plan.block_ptr[b]), int(plan.block_ptr[b + 1])
            a = int(rp[p * R]) if p < p_end else 0
            while p < p_end:
                pe = int(rp[(p + 1) * R])
                a_end = min(a + edge_chunk, pe)
                src0 = int(plan.pair_src[p]) * S
                slab = xf[src0:src0 + min(S, plan.num_src - src0), cols]
                for g in range(-(-R // rows_per_group)):
                    for r in range(g * rows_per_group,
                                   min((g + 1) * rows_per_group, R)):
                        lo = max(int(rp[p * R + r]), a)
                        hi = min(int(rp[p * R + r + 1]), a_end)
                        for j in range(lo, hi):
                            s = int(plan.col[j]) - src0
                            assert 0 <= s < slab.shape[0]
                            acc[r] += wts[j] * slab[s]
                            visits[j] += 1
                p, a = (p, a_end) if a_end < pe else (p + 1, a_end)
            out[b * R:b * R + nrows, cols] = acc[:nrows]
    assert (visits == -(-F // ft)).all()
    return out


def _layout_case(name):
    """(plan, x, w, the JAX plan, forward of the JAX plan) for a PLANS
    entry or the hybrid's dense part."""
    if name == "hybrid":
        src, dst, w, x = _hybrid_case()
        n = x.shape[0]
        plan = kops.build_hybrid_plan(src, dst, n, R=64, S=64, ET=128)
        jplan = jax_build_hybrid(src, dst, n, R=64, S=64, ET=128)
        return plan, x, w, jplan, functools.partial(jax_spmm_hybrid,
                                                    interpret=True)
    kw, n_dst, tiling = PLANS[name]
    src, dst, w, x = _case(**kw)
    plan = kops.build_block_pair_plan(src, dst, n_dst, num_src=x.shape[0],
                                      **tiling)
    jplan = jax_build(src, dst, n_dst, num_src=x.shape[0], **tiling)
    return plan, x, w, jplan, jax_spmm_block_pair


@pytest.mark.parametrize("F", [7, 100])
@pytest.mark.parametrize("name", sorted(PLANS) + ["hybrid"])
def test_plan_layout_is_what_the_kernel_reads(name, F):
    """The contract of csrc/block_pair.cu: pairs ascend by source block
    within a destination block; row_ptr gives, for every pair and row of
    its block, that row's edges, whose sources lie in the pair's source
    block, ascending. The kernel's schedule (column chunks, steps of the
    kernel's size and of 3 edges, so pairs are cut into several steps,
    lane groups of rows) emulated in numpy sums to the plain version
    (1e-5) and to the JAX Pallas kernel in interpret mode (1e-4)."""
    plan, x, w, jplan, jax_fn = _layout_case(name)
    rng = np.random.default_rng(F)
    x = rng.normal(size=(x.shape[0], F)).astype(np.float32)
    hybrid = name == "hybrid"
    bp = plan.bp if hybrid else plan
    R, S = bp.R, bp.S
    rp = bp.row_ptr
    want_ids = (np.sort(np.concatenate([bp.w_perm, plan.csr.perm]))
                if hybrid else np.sort(bp.w_perm))
    np.testing.assert_array_equal(want_ids, np.arange(len(w)))
    for b in range(bp.nblocks):
        pairs = list(range(bp.block_ptr[b], bp.block_ptr[b + 1]))
        assert list(bp.pair_src[pairs]) == sorted(set(bp.pair_src[pairs]))
        for p in pairs:
            s0 = int(bp.pair_src[p]) * S
            assert rp[(p + 1) * R] > rp[p * R]  # a pair holds edges
            for r in range(R):
                lo, hi = rp[p * R + r], rp[p * R + r + 1]
                assert (bp.row[lo:hi] == b * R + r).all()
                c = bp.col[lo:hi]
                assert ((c >= s0) & (c < s0 + S)).all()
                assert (np.diff(c) >= 0).all()
    tw = torch.from_numpy(w)
    want = kops.spmm_block_pair_reference(torch.from_numpy(x), tw, bp)
    for chunk in (None, 3):
        got = _emulate_forward(bp, x, w, chunk)
        _close(got, want, 1e-5)
    if hybrid:  # the CSR tail's plain version adds the rest
        got = got + kops.spmm_csr(torch.from_numpy(x),
                                  tw[torch.from_numpy(plan.csr.perm)],
                                  plan.csr, weights_padded=True).numpy()
    _close(got, jax_fn(jnp.asarray(x), jnp.asarray(w), jplan), 1e-4)


@pytest.mark.parametrize("F", [7, 40, 128])
@pytest.mark.parametrize("weights", ["none", "given", "padded"])
def test_f32_matches_jax_pallas_and_xla(F, weights):
    src, dst, w, x = _case(seed=F, f=F)
    jplan = jax_build(src, dst, 40, R=8, S=8, ET=16)
    plan = kops.build_block_pair_plan(src, dst, 40, R=8, S=8, ET=16)
    jw = None if weights == "none" else jnp.asarray(w)
    want_pallas = jax_spmm_block_pair(jnp.asarray(x), jw, jplan)
    want_xla = jax_spmm(jnp.asarray(np.stack([src, dst])), jw,
                        jnp.asarray(x), num_nodes=40)
    tw = None if weights == "none" else torch.from_numpy(w)
    if weights == "padded":
        tw = tw[torch.from_numpy(plan.w_perm).long()]
    got = kops.spmm_block_pair(torch.from_numpy(x), tw, plan,
                               weights_padded=weights == "padded")
    assert got.dtype == torch.float32 and got.shape == (40, F)
    _close(got, want_xla, 1e-5)
    _close(got, want_pallas, 1e-4)


@pytest.mark.parametrize("F", [7, 40])
def test_bf16_within_rounding_of_f32_reference(F):
    src, dst, w, x = _case(seed=20 + F, f=F, band=8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    plan = kops.build_block_pair_plan(src, dst, 40, R=8, S=8, ET=16)
    got = kops.spmm_block_pair(xb, torch.from_numpy(w), plan)
    assert got.dtype == torch.bfloat16
    want = jax_spmm(jnp.asarray(np.stack([src, dst])), jnp.asarray(w),
                    jnp.asarray(xb.float().numpy()), num_nodes=40)
    _close(got.float(), want, 2e-2)
    jplan = jax_build(src, dst, 40, R=8, S=8, ET=16)
    jgot = jax_spmm_block_pair(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                               jnp.asarray(w), jplan)
    _close(np.asarray(jgot, np.float32), want, 2e-2)


def test_rectangular_unweighted_matches_jax():
    """30 sources feeding 20 destinations (the JAX test's case)."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 30, 120)
    dst = rng.integers(0, 20, 120)
    x = rng.normal(size=(30, 8)).astype(np.float32)
    plan = kops.build_block_pair_plan(src, dst, 20, num_src=30, R=8, S=8,
                                      ET=16)
    got = kops.spmm_block_pair(torch.from_numpy(x), None, plan)
    want = jax_spmm(jnp.asarray(np.stack([src, dst])), None, jnp.asarray(x),
                    num_nodes=20)
    _close(got, want, 1e-5)
    jplan = jax_build(src, dst, 20, num_src=30, R=8, S=8, ET=16)
    _close(got, jax_spmm_block_pair(jnp.asarray(x), None, jplan), 1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_no_edges_gives_zeros_as_jax(weighted):
    """E = 0: the JAX plan holds one empty tile per destination block
    (fill 0) and its kernel writes zeros; the port's plan holds no pair,
    and every destination block writes zeros."""
    none = np.zeros(0, np.int64)
    jplan = jax_build(none, none, 20, num_src=12, R=8, S=8, ET=16)
    plan = kops.build_block_pair_plan(none, none, 20, num_src=12, R=8, S=8,
                                      ET=16)
    assert (plan.E_pad, plan.T, plan.fill_ratio) == (jplan.E_pad, jplan.T,
                                                     0.0)
    x = np.ones((12, 5), np.float32)
    w = np.zeros(0, np.float32) if weighted else None
    want = jax_spmm_block_pair(jnp.asarray(x),
                               None if w is None else jnp.asarray(w), jplan)
    got = kops.spmm_block_pair(torch.from_numpy(x),
                               None if w is None else torch.from_numpy(w),
                               plan)
    assert got.shape == (20, 5) and bool((got == 0).all())
    np.testing.assert_array_equal(np.asarray(want), 0)


def test_reorder_round_trip():
    """The permutation contract: x in the plan's ids (x[perm_nodes]), the
    output un-permuted, weights in the caller's order; as the JAX test."""
    src, dst, w, x = _case(seed=3, n=32, e=150, f=4, band=6)
    plan = kops.build_block_pair_plan(src, dst, 32, R=8, S=8, ET=16,
                                      reorder=True)
    out_re = kops.spmm_block_pair(torch.from_numpy(x[plan.perm_nodes]),
                                  torch.from_numpy(w), plan).numpy()
    out = np.empty_like(out_re)
    out[plan.perm_nodes] = out_re
    want = jax_spmm(jnp.asarray(np.stack([src, dst])), jnp.asarray(w),
                    jnp.asarray(x))
    _close(out, want, 1e-5)
    jplan = jax_build(src, dst, 32, R=8, S=8, ET=16, reorder=True)
    jout = jax_spmm_block_pair(jnp.asarray(x[jplan.perm_nodes]),
                               jnp.asarray(w), jplan)
    _close(out_re, jout, 1e-4)


@pytest.mark.parametrize("weights", ["none", "given", "padded"])
@pytest.mark.parametrize("extra_rows", [0, 3])
def test_gradients_match_jax_grad(weights, extra_rows):
    """dx through the transpose plan and dw per edge, against jax.grad of
    the JAX `spmm_block_pair` (Pallas forward, XLA VJP: 1e-4) and
    `ops.spmm` (XLA: 1e-5). ``extra_rows``: x has rows no edge reads."""
    src, dst, w, _ = _case(seed=2, n=24, e=100, n_src=30)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(30 + extra_rows, 6)).astype(np.float32)
    g = rng.normal(size=(24, 6)).astype(np.float32)
    use_w = weights != "none"
    jplan = jax_build(src, dst, 24, num_src=30 + extra_rows, R=8, S=8, ET=16)
    ei = jnp.asarray(np.stack([src, dst]))

    def loss_pallas(x, w):
        return jnp.sum(jax_spmm_block_pair(x, w if use_w else None, jplan)
                       * g)

    def loss_xla(x, w):
        return jnp.sum(jax_spmm(ei, w if use_w else None, x, num_nodes=24)
                       * g)

    want_p = jax.jit(jax.grad(loss_pallas, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    want_x = jax.jit(jax.grad(loss_xla, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    plan = kops.build_block_pair_plan(src, dst, 24, num_src=30, R=8, S=8,
                                      ET=16)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    arg = None if not use_w else (
        tw[torch.from_numpy(plan.w_perm).long()] if weights == "padded"
        else tw)
    out = kops.spmm_block_pair(tx, arg, plan,
                               weights_padded=weights == "padded")
    (out * torch.tensor(g)).sum().backward()
    _close(tx.grad, want_x[0], 1e-5)
    _close(tx.grad, want_p[0], 1e-4)
    assert bool((tx.grad[30:] == 0).all())
    if use_w:
        _close(tw.grad, want_x[1], 1e-5)
        _close(tw.grad, want_p[1], 1e-4)
        _close(kops.block_pair_dw(tx.detach(), torch.tensor(g), plan),
               want_x[1], 1e-5)
    else:
        assert tw.grad is None


def test_grads_of_sum_of_squares_match_jax():
    """The JAX test's entry point: the gradient of sum(out^2) in x and w."""
    src, dst, w, x = _case(seed=2, n=24, e=100, f=6)
    plan = kops.build_block_pair_plan(src, dst, 24, R=8, S=8, ET=16)
    jplan = jax_build(src, dst, 24, R=8, S=8, ET=16)
    want = jax.grad(lambda x, w: (jax_spmm_block_pair(x, w, jplan) ** 2)
                    .sum(), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    (kops.spmm_block_pair(tx, tw, plan) ** 2).sum().backward()
    _close(tx.grad, want[0], 1e-4)
    _close(tw.grad, want[1], 1e-4)


def test_transpose_plan():
    src, dst, w, x = _case(seed=9, n=30, e=160, n_src=45)
    plan = kops.build_block_pair_plan(src, dst, 30, num_src=45, R=8, S=16,
                                      ET=16)
    tp = plan.transpose()
    assert plan.transpose() is tp  # built once
    assert (tp.num_nodes, tp.num_src, tp.R, tp.S) == (45, 30, 16, 8)
    np.testing.assert_array_equal(tp.w_perm, plan.w_perm[tp.fwd_pos])
    np.testing.assert_array_equal(tp.row, plan.col[tp.fwd_pos])
    g = torch.randn(30, 5)
    tw = torch.from_numpy(w)
    want = torch.zeros(45, 5).index_add_(
        0, torch.from_numpy(src), g[torch.from_numpy(dst)] * tw[:, None])
    torch.testing.assert_close(kops.spmm_block_pair(g, tw, tp), want)
    # weights in the forward plan's order are read through fwd_pos
    padded = tw[torch.from_numpy(plan.w_perm).long()]
    torch.testing.assert_close(
        kops.spmm_block_pair(g, padded, tp, weights_padded=True), want)


def _hybrid_case():
    """The JAX test's mixed graph: dense 64x64 diagonal windows and a
    scattered tail; (src, dst, w, x)."""
    rng = np.random.default_rng(7)
    n = 512
    sd, dd = [], []
    for b in range(n // 64):
        sd.append(b * 64 + rng.integers(0, 64, 800))
        dd.append(b * 64 + rng.integers(0, 64, 800))
    sd.append(rng.integers(0, n, 700))
    dd.append(rng.integers(0, n, 700))
    src, dst = np.concatenate(sd), np.concatenate(dd)
    w = rng.normal(size=len(src)).astype(np.float32)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    return src, dst, w, x


def test_hybrid_plan_matches_jax():
    """The JAX test's mixed graph: dense 64x64 diagonal windows and a
    scattered tail. The split, the sub-plans' sizes, the forward and both
    gradients match."""
    src, dst, w, x = _hybrid_case()
    n = x.shape[0]
    jplan = jax_build_hybrid(src, dst, n, R=64, S=64, ET=128)
    plan = kops.build_hybrid_plan(src, dst, n, R=64, S=64, ET=128)
    assert plan.dense_frac == jplan.dense_frac > 0.5
    assert (plan.bp is None, plan.csr is None) == (jplan.bp is None,
                                                   jplan.csr is None)
    assert (plan.bp.E_pad, plan.bp.T, plan.bp.fill_ratio) == (
        jplan.bp.E_pad, jplan.bp.T, jplan.bp.fill_ratio)
    assert plan.csr.num_edges == int((jplan.csr.perm < len(src)).sum())

    def jloss(x, w):
        return jnp.sum(jax_spmm_hybrid(x, w, jplan, interpret=True) ** 2)

    want = jax_spmm_hybrid(jnp.asarray(x), jnp.asarray(w), jplan,
                           interpret=True)
    want_g = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = kops.spmm_hybrid(tx, tw, plan)
    _close(out.detach(), want, 1e-4)
    (out ** 2).sum().backward()
    _close(tx.grad, want_g[0], 1e-4)
    _close(tw.grad, want_g[1], 1e-4)
    # dense reference
    a = np.zeros((n, n))
    np.add.at(a, (dst, src), w)
    _close(out.detach(), a @ x.astype(np.float64), 1e-5)


@pytest.mark.parametrize("weights", [False, True])
def test_create_graph_raises(weights):
    """No backward of the kernels' own: a backward that would build a
    graph for second derivatives raises, on the CPU as on the card."""
    src, dst, w, x = _case(seed=34, n=20, e=80)
    plan = kops.build_block_pair_plan(src[src < 20], dst[src < 20], 20,
                                      R=8, S=8, ET=16)
    tx = torch.randn(20, 4, requires_grad=True)
    tw = (torch.rand(plan.num_edges, requires_grad=True) if weights
          else None)
    loss = (kops.spmm_block_pair(tx, tw, plan) ** 2).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, tx, create_graph=True)
    dx, = torch.autograd.grad(loss, tx)
    assert dx.shape == tx.shape


def test_wrapper_checks_inputs():
    plan = kops.build_block_pair_plan([0, 1, 2], [1, 2, 0], 3, R=8, S=8,
                                      ET=16)
    with pytest.raises(ValueError, match="2-D"):
        kops.spmm_block_pair(torch.ones(3), None, plan)
    with pytest.raises(ValueError, match="rows"):
        kops.spmm_block_pair(torch.ones(2, 4), None, plan)
    with pytest.raises(ValueError, match="shape"):
        kops.spmm_block_pair(torch.ones(3, 4), torch.ones(5), plan)
    with pytest.raises(ValueError, match="no kernel"):
        kops.spmm_block_pair(torch.ones(3, 4, device="meta"), None, plan)
    with pytest.raises(ValueError, match="out of range"):
        kops.build_block_pair_plan([0, 3], [0, 1], 3)
    with pytest.raises(ValueError, match="square"):
        kops.build_block_pair_plan([0], [1], 3, num_src=4, reorder=True)


def test_cpu_path_neither_builds_nor_counts():
    plan = kops.build_block_pair_plan([0, 1, 2], [1, 2, 0], 3, R=2, S=2,
                                      ET=4)
    before = (kops.spmm_block_pair.launches, kops.block_pair_dw.launches)
    misses = _build.load_library.cache_info().misses
    x = torch.eye(3, requires_grad=True)
    w = torch.ones(3, requires_grad=True)
    out = kops.spmm_block_pair(x, w, plan)
    np.testing.assert_array_equal(out.detach().numpy(), np.eye(3)[[2, 0, 1]])
    out.sum().backward()
    assert (kops.spmm_block_pair.launches,
            kops.block_pair_dw.launches) == before
    assert _build.load_library.cache_info().misses == misses


def test_plan_caches_one_copy_per_device():
    plan = kops.build_block_pair_plan([0, 1], [1, 0], 2, R=2, S=2, ET=2)
    first = plan.arrays("cpu")
    assert all(a is b for a, b in zip(first, plan.arrays(torch.device("cpu"))))
    assert first[6] is None  # a forward plan has no fwd_pos
    with torch.inference_mode():  # cached copies stay ordinary tensors
        fresh = kops.build_block_pair_plan([0], [1], 2).arrays("cpu")
    assert not any(a.is_inference() for a in fresh if a is not None)
