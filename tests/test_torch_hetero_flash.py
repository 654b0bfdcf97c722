"""The port's HGT relation attention (`hgt_flash_packed`, forward and both
gradients) against the JAX package.

* bf16, at the sizes of `tests/ops/test_hetero_flash.py` ((H, D) in
  {(2, 64), (1, 64), (4, 32)}), against the JAX `hgt_flash_packed` (its
  Pallas kernels in interpret mode on a window plan), at init: within
  3e-2 of max |out| (of max |grad| for the gradients). The TPU kernels
  round p and ds to bf16 before their products; the port sums in f32.
* f32, against the decomposed formula (per-edge scores, `segment_softmax`,
  weighted `spmm`) in XLA and its `jax.grad`: within 1e-5.

On the CPU the port runs its plain versions; rows without edges are 0.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu import ops as jops
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.ops.pallas.hetero_flash import \
    hgt_flash_packed as jax_hgt_flash_packed

from gammagl_tpu_torch.ops import cuda as k


def _case(seed=0, n_src=150, n_dst=90, e=1200, H=2, D=64):
    """The JAX test's bipartite case: dst rows 83..89 get no edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst - 7, e)
    kv = rng.normal(size=(n_src, 2 * H * D)).astype(np.float32)
    q = (rng.normal(size=(n_dst, H, D)) / np.sqrt(D)).astype(np.float32)
    gout = rng.normal(size=(n_dst, H * D)).astype(np.float32)
    return src, dst, kv, q, gout


def _port(kv, q, gout, plan, dtype):
    tkv = torch.tensor(kv).to(dtype).requires_grad_()
    tq = torch.tensor(q).to(dtype).requires_grad_()
    out = k.hgt_flash_packed(tkv, tq, plan)
    (out.float() * torch.tensor(gout)).sum().backward()
    return out, tkv.grad, tq.grad


def _check(got, want, tol):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("H,D,e,seed", [(2, 64, 1200, 0), (1, 64, 800, 3),
                                        (4, 32, 800, 4)])
def test_bf16_matches_the_jax_kernels_at_init(H, D, e, seed):
    src, dst, kv, q, gout = _case(seed, e=e, H=H, D=D)
    jplan = jax_build_csr_plan(src, dst, 90, num_src=150, R=16, ET=128,
                               window=True)
    tplan = k.build_csr_plan(src, dst, 90, num_src=150, window=True)
    jkv = jnp.asarray(kv, jnp.bfloat16)
    jq = jnp.asarray(q, jnp.bfloat16)

    def loss(a, b):
        out = jax_hgt_flash_packed(a, b, jplan)
        return jnp.sum(out.astype(jnp.float32) * gout), out

    (_, want), (dkv, dq) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jkv, jq)
    out, gkv, gq = _port(np.asarray(jkv, np.float32),
                         np.asarray(jq, np.float32), gout, tplan,
                         torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (90, H * D)
    _check(out, want, 3e-2)
    _check(gkv, dkv, 3e-2)
    _check(gq, dq, 3e-2)
    assert bool((out[83:] == 0).all()) and bool((gq[83:] == 0).all())


def _decomposed(kv, q, src, dst, n_dst, H, D, gout):
    """Per-edge scores, segment softmax and weighted sum in XLA, f32; the
    output and jax.grad of sum(out * gout) in kv and q."""
    sj, dj = jnp.asarray(src), jnp.asarray(dst)

    def f(kv, q):
        k_ = kv[:, :H * D].reshape(-1, H, D)
        v = kv[:, H * D:].reshape(-1, H, D)
        s = jnp.einsum("ehd,ehd->eh", q[dj], k_[sj])
        outs = [jops.spmm(jnp.stack([sj, dj]),
                          jops.segment_softmax(s[:, h], dj, n_dst), v[:, h],
                          num_nodes=n_dst) for h in range(H)]
        out = jnp.stack(outs, 1).reshape(n_dst, H * D)
        return jnp.sum(out * gout), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(kv), jnp.asarray(q))
    return out, grads


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("H,D", [(2, 64), (4, 32), (3, 5)])
def test_f32_matches_the_decomposed_formula(H, D, window):
    src, dst, kv, q, gout = _case(5, e=700, H=H, D=D)
    plan = k.build_csr_plan(src, dst, 90, num_src=150, window=window)
    out, gkv, gq = _port(kv, q, gout, plan, torch.float32)
    want, (dkv, dq) = _decomposed(kv, q, src, dst, 90, H, D, gout)
    _check(out, want, 1e-5)
    _check(gkv, dkv, 1e-5)
    _check(gq, dq, 1e-5)


def test_no_edges_and_more_kv_rows_than_sources():
    none = np.zeros(0, np.int64)
    plan = k.build_csr_plan(none, none, 6, num_src=4)
    kv = torch.randn(7, 2 * 2 * 8, requires_grad=True)
    q = torch.randn(6, 2, 8, requires_grad=True)
    out = k.hgt_flash_packed(kv, q, plan)
    assert out.shape == (6, 16) and bool((out == 0).all())
    out.sum().backward()
    assert bool((kv.grad == 0).all()) and bool((q.grad == 0).all())
    # the plain forward saves the JAX kernels' statistics for empty rows
    _, m, l = k.hgt_forward(kv.detach(), q.detach(), plan)
    assert bool((m == -1e30).all()) and bool((l == 0).all())


def test_checks_and_create_graph():
    src, dst, kv, q, _ = _case(6, e=200, H=2, D=8)
    plan = k.build_csr_plan(src, dst, 90, num_src=150)
    tkv = torch.tensor(kv, requires_grad=True)
    tq = torch.tensor(q)
    with pytest.raises(ValueError, match="2\\*H\\*D"):
        k.hgt_flash_packed(tkv[:, 1:], tq, plan)
    with pytest.raises(ValueError, match="rows"):
        k.hgt_flash_packed(tkv, tq[1:], plan)
    with pytest.raises(TypeError, match="differ"):
        k.hgt_flash_packed(tkv, tq.double(), plan)
    before = (k.hgt_forward.launches, k.hgt_backward.launches)
    loss = k.hgt_flash_packed(tkv, tq, plan).sum()
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(loss, tkv, create_graph=True)
    assert (k.hgt_forward.launches, k.hgt_backward.launches) == before
