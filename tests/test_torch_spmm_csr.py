"""The port's CSR SpMM (gammagl_tpu_torch.ops.cuda) against the JAX package.

On the CPU `spmm_csr` runs its plain version; the same numpy inputs go
through JAX `spmm_csr` on `Graph.csr_plan()` (the Pallas kernels, which
interpret themselves off-TPU) and through JAX `ops.spmm` (XLA).

Tolerances: f32 1e-5 against XLA, 1e-4 against Pallas, whose f32 path is
a bf16x3 split that drops the lo*lo term (segment_matmul.py:276-281).
bf16 rtol 2e-2 against an f32 reference of the same bf16 inputs: the JAX
bf16 kernels add tiles together in bf16, the port rounds once.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.ops import spmm as jax_spmm
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas import spmm_csr as jax_spmm_csr

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.ops.cuda import _build


def _graph(seed, n_dst=200, n_src=None, e=1500, empty_rows=False):
    rng = np.random.default_rng(seed)
    n_src = n_dst if n_src is None else n_src
    dst = (n_dst * rng.random(e) ** 1.5).astype(np.int64)
    if empty_rows:  # odd rows and the top fifth get no edges
        dst = 2 * (dst * 2 // 5)
    src = rng.integers(0, n_src, e)
    w = rng.random(e).astype(np.float32)
    return src, dst, w, n_dst, n_src


def _close(got, want, rtol):
    """|got - want| <= rtol*|want| + 1e-5*max|want|; the second term covers
    sums taken in different orders."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("F", [7, 40, 128, 256])
@pytest.mark.parametrize("weights", ["none", "given", "padded"])
def test_f32_matches_jax_pallas_and_xla(F, weights):
    src, dst, w, n, _ = _graph(F)
    x = np.random.default_rng(F + 1).normal(size=(n, F)).astype(np.float32)
    ei = np.stack([src, dst])
    plan = Graph(edge_index=ei, num_nodes=n).csr_plan()
    jplan = JaxGraph(edge_index=ei, num_nodes=n).csr_plan()
    jw = None if weights == "none" else jnp.asarray(w)
    want_pallas = jax_spmm_csr(jnp.asarray(x), jw, jplan)
    want_xla = jax_spmm(jnp.asarray(ei), jw, jnp.asarray(x), num_nodes=n)
    tw = None if weights == "none" else torch.from_numpy(w)
    if weights == "padded":
        tw = kops.pad_edge_weights(plan, tw)
    got = kops.spmm_csr(_t(x), tw, plan, weights_padded=weights == "padded")
    assert got.dtype == torch.float32 and got.shape == (n, F)
    _close(got, want_xla, 1e-5)
    _close(got, want_pallas, 1e-4)


@pytest.mark.parametrize("F", [7, 40, 128, 256])
def test_bf16_within_rounding_of_f32_reference(F):
    src, dst, w, n, _ = _graph(10 + F)
    x = np.random.default_rng(F).normal(size=(n, F)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    plan = kops.build_csr_plan(src, dst, n)
    got = kops.spmm_csr(xb, torch.from_numpy(w), plan)
    assert got.dtype == torch.bfloat16
    # f32 reference of the same bf16 inputs, from the JAX package
    want = jax_spmm(jnp.asarray(np.stack([src, dst])), jnp.asarray(w),
                    jnp.asarray(xb.float().numpy()), num_nodes=n)
    _close(got.float(), want, 2e-2)


def test_src_count_differs_from_dst_count():
    src, dst, w, n_dst, n_src = _graph(3, n_dst=150, n_src=230)
    x = np.random.default_rng(4).normal(size=(n_src, 40)).astype(np.float32)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    got = kops.spmm_csr(_t(x), torch.from_numpy(w), plan)
    assert got.shape == (n_dst, 40)
    want = jax_spmm(jnp.asarray(np.stack([src, dst])), jnp.asarray(w),
                    jnp.asarray(x), num_nodes=n_dst)
    _close(got, want, 1e-5)
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src)
    _close(got, jax_spmm_csr(jnp.asarray(x), jnp.asarray(w), jplan), 1e-4)


def test_empty_rows_are_exact_zeros():
    src, dst, w, n, _ = _graph(5, empty_rows=True)
    plan = kops.build_csr_plan(src, dst, n)
    x = _t(np.random.default_rng(6).normal(size=(n, 16)))
    out = kops.spmm_csr(x, torch.from_numpy(w), plan)
    empty = np.bincount(dst, minlength=n) == 0
    assert empty.sum() > n // 2
    assert bool((out[torch.from_numpy(empty)] == 0).all())
    want = jax_spmm(jnp.asarray(np.stack([src, dst])), jnp.asarray(w),
                    jnp.asarray(x.numpy()), num_nodes=n)
    _close(out, want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_edges(dtype):
    none = np.zeros(0, np.int64)
    plan = kops.build_csr_plan(none, none, 9, num_src=4)
    assert plan.num_edges == 0 and (plan.rowptr == 0).all()
    x = torch.ones(4, 7, dtype=dtype)
    out = kops.spmm_csr(x, torch.zeros(0), plan)
    assert out.dtype == dtype and out.shape == (9, 7)
    assert bool((out == 0).all())
    jout = jax_spmm_csr(jnp.ones((9, 7)), jnp.zeros(0),
                        jax_build_csr_plan(none, none, 9, window=True))
    np.testing.assert_array_equal(np.asarray(jout), 0)


def test_plan_invariants():
    src, dst, _, n, _ = _graph(7, empty_rows=True)
    plan = kops.build_csr_plan(src, dst, n)
    assert plan.rowptr.dtype == np.int64 and plan.col.dtype == np.int32
    assert plan.rowptr.shape == (n + 1,) and plan.rowptr[0] == 0
    assert plan.rowptr[-1] == len(src) == plan.num_edges
    assert (np.diff(plan.rowptr) >= 0).all()
    # perm is a permutation, and carries the stable dst sort
    np.testing.assert_array_equal(np.sort(plan.perm), np.arange(len(src)))
    np.testing.assert_array_equal(plan.perm,
                                  np.argsort(dst, kind="stable"))
    np.testing.assert_array_equal(plan.col, src[plan.perm])
    rows = np.repeat(np.arange(n), np.diff(plan.rowptr))
    np.testing.assert_array_equal(rows, dst[plan.perm])


def test_tpu_tiling_keywords_are_ignored():
    src, dst, _, n, _ = _graph(8)
    base = kops.build_csr_plan(src, dst, n)
    tiled = kops.build_csr_plan_blocked(src, dst, n, R=8, ET=32,
                                        num_src_blocks=3, window=True)
    for name in ("rowptr", "col", "perm"):
        np.testing.assert_array_equal(getattr(base, name),
                                      getattr(tiled, name))


def test_out_of_range_edges_raise():
    with pytest.raises(ValueError, match="dst out of range"):
        kops.build_csr_plan([0, 1], [0, 5], 5)
    with pytest.raises(ValueError, match="src out of range"):
        kops.build_csr_plan([0, 3], [0, 1], 5, num_src=3)


def test_wrapper_checks_inputs():
    plan = kops.build_csr_plan([0, 1, 2], [1, 2, 0], 3)
    with pytest.raises(ValueError, match="2-D"):
        kops.spmm_csr(torch.ones(3), None, plan)
    with pytest.raises(ValueError, match="rows"):
        kops.spmm_csr(torch.ones(2, 4), None, plan)
    with pytest.raises(ValueError, match="shape"):
        kops.spmm_csr(torch.ones(3, 4), torch.ones(5), plan)
    with pytest.raises(ValueError, match="no kernel"):
        kops.spmm_csr(torch.ones(3, 4, device="meta"), None, plan)


def test_cpu_path_neither_builds_nor_counts():
    plan = kops.build_csr_plan([0, 1, 2], [1, 2, 0], 3)
    before = kops.spmm_csr.launches
    misses = _build.load_library.cache_info().misses
    out = kops.spmm_csr(torch.eye(3), None, plan)
    np.testing.assert_array_equal(out.numpy(), np.eye(3)[[2, 0, 1]])
    assert kops.spmm_csr.launches == before
    assert _build.load_library.cache_info().misses == misses


def test_plan_caches_one_copy_per_device():
    plan = kops.build_csr_plan([0, 1], [1, 0], 2)
    first = plan.arrays("cpu")
    assert all(a is b for a, b in zip(first, plan.arrays(torch.device("cpu"))))
    with torch.inference_mode():  # cached copies stay ordinary tensors
        fresh = kops.build_csr_plan([0], [1], 2).arrays("cpu")
    assert not any(a.is_inference() for a in fresh)


def test_missing_nvcc_raises_clearly(monkeypatch):
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._find_nvcc()


def test_build_name_follows_source_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("int f();")
    before = _build._digest([src])
    assert len(before) == 16 and _build._digest([src]) == before
    src.write_text("int g();")
    assert _build._digest([src]) != before
    units, _ = _build._sources()
    assert [u.name for u in units] == ["block_pair.cu", "flash_attention.cu",
                                       "hetero_flash.cu", "sddmm_csr.cu",
                                       "segment_max.cu", "spmm_csr.cu"]


@pytest.mark.parametrize("weights", ["none", "given", "padded"])
@pytest.mark.parametrize("extra_rows", [0, 3])
def test_gradients_match_jax_grad(weights, extra_rows):
    """dx through the transpose plan and dw as a rowdot, against jax.grad
    of the JAX `spmm_csr` (Pallas, 1e-4) and `ops.spmm` (XLA, 1e-5).
    ``extra_rows``: x has rows no edge reads, which get zero gradient."""
    src, dst, w, n_dst, n_src = _graph(31, n_dst=60, n_src=45, e=400)
    rng = np.random.default_rng(32)
    x = rng.normal(size=(n_src + extra_rows, 24)).astype(np.float32)
    g = rng.normal(size=(n_dst, 24)).astype(np.float32)
    ei = jnp.asarray(np.stack([src, dst]))
    jplan = jax_build_csr_plan(src, dst, n_dst, num_src=n_src + extra_rows)
    use_w = weights != "none"

    def loss_pallas(x, w):
        return jnp.sum(jax_spmm_csr(x, w if use_w else None, jplan) * g)

    def loss_xla(x, w):
        out = jax_spmm(ei, w if use_w else None, x, num_nodes=n_dst)
        return jnp.sum(out * g)

    want_p = jax.jit(jax.grad(loss_pallas, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    want_x = jax.jit(jax.grad(loss_xla, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(w))
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    arg = None if not use_w else (
        kops.pad_edge_weights(plan, tw) if weights == "padded" else tw)
    out = kops.spmm_csr(tx, arg, plan, weights_padded=weights == "padded")
    (out * torch.tensor(g)).sum().backward()
    _close(tx.grad, want_x[0], 1e-5)
    _close(tx.grad, want_p[0], 1e-4)
    assert bool((tx.grad[n_src:] == 0).all())
    if use_w:
        _close(tw.grad, want_x[1], 1e-5)
        _close(tw.grad, want_p[1], 1e-4)
    else:
        assert tw.grad is None


def test_transpose_plans():
    src, dst, w, n_dst, n_src = _graph(33, n_dst=50, n_src=35, e=300)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    tp = plan.transpose()
    assert plan.transpose() is tp  # built once
    assert (tp.num_nodes, tp.num_src, tp.num_edges) == (n_src, n_dst, 300)
    rows = np.repeat(np.arange(n_dst), np.diff(plan.rowptr))
    # transpose CSR edge j is forward CSR edge tp.perm[j], reversed
    t_rows = np.repeat(np.arange(n_src), np.diff(tp.rowptr))
    np.testing.assert_array_equal(t_rows, plan.col[tp.perm])
    np.testing.assert_array_equal(tp.col, rows[tp.perm])
    es = plan.edge_scatter_plan()
    np.testing.assert_array_equal(es.rowptr, tp.rowptr)
    np.testing.assert_array_equal(es.col, tp.perm)
    # summing per-edge rows (CSR order) into sources = index_add_ by col
    v = torch.randn(300, 5)
    want = torch.zeros(n_src, 5).index_add_(0, torch.from_numpy(
        plan.col).long(), v)
    torch.testing.assert_close(kops.spmm_csr(v, None, es), want)


@pytest.mark.parametrize("weights", [False, True])
def test_create_graph_raises(weights):
    """The kernel has no backward of its own: a backward that would build
    a graph for second derivatives raises, on the CPU as on the card."""
    src, dst, w, n_dst, n_src = _graph(34, n_dst=20, n_src=20, e=80)
    plan = kops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    x = torch.randn(n_src, 4, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True) if weights else None
    loss = (kops.spmm_csr(x, tw, plan) ** 2).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, x, create_graph=True)
    dx, = torch.autograd.grad(loss, x)  # first order still works
    assert dx.shape == x.shape
