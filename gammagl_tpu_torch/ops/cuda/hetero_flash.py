"""HGT relation attention over a CSR plan: one kernel forward, one backward.

PyTorch counterpart of `gammagl_tpu/ops/pallas/hetero_flash.py`. For each
destination row d and head h, over the plan's CSR edges e of d:

    out[d, h] = sum_e softmax_d(<q_scaled[d, h], k[src_e, h]>)_e * v[src_e, h]

with ``kv`` (N_src, 2*H*D) holding ``[k | v]`` per source row. The TPU
module packs bf16 k|v pairs into f32 words for its gather engine and scores
tiles on the matrix unit; the card's kernels (``csrc/hetero_flash.cu``)
read the k|v rows at ``col[e]`` themselves, one warp per destination row,
and sum in float32 (the TPU kernels round p and ds to bf16 before their
products, so the two agree to bf16 rounding, not bit for bit).

`hgt_flash_packed` is a `torch.autograd.Function`: the forward kernel
saves the row statistics (m, l); the backward kernel recomputes alpha from
them and writes dq per row and dk|dv per CSR edge, which `spmm_csr` on the
plan's edge-scatter transpose sums into source rows (no atomics). The
kernels are the ``torch.library`` ops ``gammagl::hgt_forward`` and
``gammagl::hgt_backward``, on the plan's rowptr and col. On a
CUDA tensor each launches its kernel or raises (counted in
``hgt_forward.launches`` and ``hgt_backward.launches``); on a CPU tensor
both run their plain versions. Differentiable once.
"""

import ctypes
import functools

import torch

from gammagl_tpu_torch.ops.cuda._build import load_library
from gammagl_tpu_torch.ops.cuda.segment_matmul import (PlanArrays, _csr_rows,
                                                       _first_order_only,
                                                       _forward, _pad_rows,
                                                       _raise_on)
from gammagl_tpu_torch.ops.cuda.segment_matmul import _kernel as _spmm_kernel

__all__ = ["hgt_flash_packed", "hgt_forward", "hgt_backward",
           "hgt_forward_reference", "hgt_backward_reference"]

_NEG = -1e30  # the row max before any edge, as in the JAX kernels
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _edge_rows(kv, q, plan):
    """Per CSR edge: k, v (E, H, D) and q (E, H, D) in float32, and the
    destination rows."""
    H, D = q.shape[1], q.shape[2]
    rows = _csr_rows(plan, kv.device)
    g = kv[plan.arrays(kv.device)[1].long()].float()
    k = g[:, :H * D].view(-1, H, D)
    v = g[:, H * D:].view(-1, H, D)
    return k, v, q.float()[rows], rows


def hgt_forward_reference(kv, q, plan):
    """Plain PyTorch forward: (out (N_dst, H*D) of kv's dtype, m, l
    (N_dst, H) float32), sums in float32."""
    N, H, D = q.shape
    k, v, qe, rows = _edge_rows(kv, q, plan)
    s = (qe * k).sum(-1)
    m = torch.full((N, H), _NEG, device=kv.device).scatter_reduce_(
        0, rows[:, None].expand_as(s), s, "amax")
    p = torch.exp(s - m[rows])
    l = torch.zeros(N, H, device=kv.device).index_add_(0, rows, p)
    acc = torch.zeros(N, H, D, device=kv.device).index_add_(
        0, rows, p[:, :, None] * v)
    out = acc / l.clamp_min(1e-16)[:, :, None]
    return out.to(kv.dtype).view(N, H * D), m, l


def hgt_backward_reference(kv, q, out, grad, m, l, plan):
    """Plain PyTorch backward: (dq (N_dst, H*D), dkv (E, 2*H*D) per CSR
    edge, [dk | dv]), both of kv's dtype, sums in float32."""
    N, H, D = q.shape
    k, v, qe, rows = _edge_rows(kv, q, plan)
    s = (qe * k).sum(-1)
    alpha = (torch.exp(torch.clamp_max(s - m[rows], 0.0))
             / l.clamp_min(1e-16)[rows])
    gf = grad.to(kv.dtype).float().view(N, H, D)
    c = (out.float().view(N, H, D) * gf).sum(-1)
    ds = alpha * ((gf[rows] * v).sum(-1) - c[rows])
    dq = torch.zeros(N, H, D, device=kv.device).index_add_(
        0, rows, ds[:, :, None] * k)
    dk = ds[:, :, None] * qe
    dv = alpha[:, :, None] * gf[rows]
    E = plan.num_edges
    dkv = torch.cat([dk.reshape(E, H * D), dv.reshape(E, H * D)], 1)
    return dq.to(kv.dtype).view(N, H * D), dkv.to(kv.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library()
    fwd = lib.gammagl_hgt_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3
                    + [ctypes.c_int, ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    bwd = lib.gammagl_hgt_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 3
                    + [ctypes.c_int, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, bwd, _spmm_kernel()[1]


def _check(kv, q, plan):
    """Shapes, dtypes, devices and contiguity for the kernels and the plain
    versions; returns (H, D)."""
    if q.dim() != 3 or kv.dim() != 2:
        raise ValueError(f"q_scaled must be (N_dst, H, D) and kv (N_src, "
                         f"2*H*D), got {tuple(q.shape)} and "
                         f"{tuple(kv.shape)}")
    _, H, D = q.shape
    if kv.shape[1] != 2 * H * D or H * D == 0:
        raise ValueError(f"kv width {kv.shape[1]} is not 2*H*D = {2 * H * D}")
    if q.shape[0] != plan.num_nodes:
        raise ValueError(f"q_scaled has {q.shape[0]} rows, the plan has "
                         f"{plan.num_nodes}")
    if kv.shape[0] < plan.num_src:
        raise ValueError(f"kv has {kv.shape[0]} rows, the plan reads "
                         f"{plan.num_src}")
    if kv.device != q.device or kv.dtype != q.dtype:
        raise TypeError(f"kv ({kv.dtype} on {kv.device}) and q_scaled "
                        f"({q.dtype} on {q.device}) differ")
    if kv.device.type == "cuda":
        if kv.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"hgt attention: dtype {kv.dtype} is not one of "
                            f"{_KERNEL_DTYPES}")
        if not (kv.is_contiguous() and q.is_contiguous()):
            raise ValueError("hgt attention: kv and q_scaled must be "
                             "contiguous")
    elif kv.device.type != "cpu":
        raise ValueError(f"hgt attention: no kernel for device {kv.device}")
    return H, D


def hgt_forward(kv, q, plan):
    """One forward: (out (N_dst, H*D), m, l), the op
    ``gammagl::hgt_forward``. A CPU tensor takes `hgt_forward_reference`;
    a CUDA tensor launches the kernel or raises."""
    _check(kv, q, plan)
    rowptr, col, _ = plan.arrays(kv.device)
    return torch.ops.gammagl.hgt_forward(kv, q, rowptr, col)


@torch.library.custom_op("gammagl::hgt_forward", mutates_args=())
def _hgt_forward_op(kv: torch.Tensor, q: torch.Tensor, rowptr: torch.Tensor,
                    col: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, l) of the HGT relation attention on the plan's arrays."""
    raise ValueError(f"gammagl::hgt_forward: no kernel for device "
                     f"{kv.device}")


@_hgt_forward_op.register_kernel("cpu")
def _hgt_forward_cpu(kv, q, rowptr, col):
    return hgt_forward_reference(kv, q, PlanArrays(rowptr, col))


@_hgt_forward_op.register_kernel("cuda")
def _hgt_forward_cuda(kv, q, rowptr, col):
    N, H, D = q.shape
    dev = kv.device
    out = torch.empty(N, H * D, dtype=kv.dtype, device=dev)
    m = torch.empty(N, H, device=dev)
    l = torch.empty(N, H, device=dev)
    if N == 0:
        return out, m, l
    fwd, _, err = _kernels()
    with torch.cuda.device(dev):
        code = fwd(kv.data_ptr(), q.data_ptr(), rowptr.data_ptr(),
                   col.data_ptr(), out.data_ptr(), m.data_ptr(),
                   l.data_ptr(), N, H, D, int(kv.dtype == torch.bfloat16),
                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "hgt forward", err)
    hgt_forward.launches += 1
    return out, m, l


@_hgt_forward_op.register_fake
def _hgt_forward_fake(kv, q, rowptr, col):
    N, H, D = q.shape
    return (kv.new_empty(N, H * D), q.new_empty(N, H, dtype=torch.float32),
            q.new_empty(N, H, dtype=torch.float32))


def hgt_backward(kv, q, out, grad, m, l, plan):
    """One backward: (dq (N_dst, H*D), dkv (E, 2*H*D) in CSR order), the
    op ``gammagl::hgt_backward``. A CPU tensor takes
    `hgt_backward_reference`; a CUDA tensor launches the kernel or
    raises."""
    _check(kv, q, plan)
    rowptr, col, _ = plan.arrays(kv.device)
    return torch.ops.gammagl.hgt_backward(kv, q, out, grad, m, l, rowptr,
                                          col)


@torch.library.custom_op("gammagl::hgt_backward", mutates_args=())
def _hgt_backward_op(kv: torch.Tensor, q: torch.Tensor, out: torch.Tensor,
                     grad: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     rowptr: torch.Tensor, col: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dq, dkv per CSR edge) of the HGT relation attention on the plan's
    arrays."""
    raise ValueError(f"gammagl::hgt_backward: no kernel for device "
                     f"{kv.device}")


@_hgt_backward_op.register_kernel("cpu")
def _hgt_backward_cpu(kv, q, out, grad, m, l, rowptr, col):
    return hgt_backward_reference(kv, q, out, grad, m, l,
                                  PlanArrays(rowptr, col))


@_hgt_backward_op.register_kernel("cuda")
def _hgt_backward_cuda(kv, q, out, grad, m, l, rowptr, col):
    N, H, D = q.shape
    E, dev = col.shape[0], kv.device
    grad = grad.to(kv.dtype).contiguous()
    dq = torch.empty(N, H * D, dtype=kv.dtype, device=dev)
    dkv = torch.empty(E, 2 * H * D, dtype=kv.dtype, device=dev)
    if N == 0:
        return dq, dkv
    _, bwd, err = _kernels()
    with torch.cuda.device(dev):
        code = bwd(kv.data_ptr(), q.data_ptr(), rowptr.data_ptr(),
                   col.data_ptr(), out.data_ptr(), grad.data_ptr(),
                   m.data_ptr(), l.data_ptr(), dq.data_ptr(), dkv.data_ptr(),
                   N, H, D, int(kv.dtype == torch.bfloat16),
                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "hgt backward", err)
    hgt_backward.launches += 1
    return dq, dkv


@_hgt_backward_op.register_fake
def _hgt_backward_fake(kv, q, out, grad, m, l, rowptr, col):
    N, H, D = q.shape
    return kv.new_empty(N, H * D), kv.new_empty(col.shape[0], 2 * H * D)


hgt_forward.launches = 0
hgt_backward.launches = 0


class _HGTAttention(torch.autograd.Function):
    """kv, q_scaled -> out (N_dst, H*D). Forward: one kernel launch saving
    (out, m, l). Backward: one kernel launch, then `spmm_csr` on the edge-
    scatter transpose (one more launch) for dk|dv."""

    @staticmethod
    def forward(ctx, kv, q, plan):
        out, m, l = hgt_forward(kv, q, plan)
        ctx.save_for_backward(kv, q, out, m, l)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, g):
        _first_order_only("hgt_flash_packed")
        kv, q, out, m, l = ctx.saved_tensors
        plan = ctx.plan
        dq, dkv_e = hgt_backward(kv, q, out, g, m, l, plan)
        dkv = _pad_rows(_forward(dkv_e, None, plan.edge_scatter_plan()),
                        kv.shape[0])
        return dkv, dq.view(q.shape), None


def hgt_flash_packed(kv, q_scaled, plan):
    """out[d, h] = sum_e softmax_d(<q_scaled[d, h], k[src_e, h]>)_e
    * v[src_e, h], all heads in one launch.

      kv       : (N_src, 2*H*D), columns [k | v], float32 or bfloat16
      q_scaled : (N_dst, H, D) of kv's dtype, with the relation prior and
                 1/sqrt(D) folded in (their gradients flow outside)
      plan     : a `CSRPlan` of the relation (any; the port's plans have
                 one layout)
    Returns (N_dst, H*D) of kv's dtype. The name is the JAX function's,
    though nothing is packed here. Differentiable once in kv and q_scaled.
    """
    _check(kv, q_scaled, plan)
    return _HGTAttention.apply(kv, q_scaled, plan)
