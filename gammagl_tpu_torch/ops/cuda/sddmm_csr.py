"""Per-edge endpoint ops over a CSR plan: the destination expand and SDDMM.

PyTorch counterpart of `gammagl_tpu/ops/pallas/sddmm_csr.py`. For CSR edge
e of destination row d = row(e):

* `expand_dst_csr`: ``x_dst[d]`` per edge, (E, C), the destination side of
  per-edge features (GATv2's scores, HGT, edge MLPs);
* `sddmm_csr` / `sddmm_csr_mh`: per-edge (per-head) dots
  ``<x_src[src_e], x_dst[d]>``, f32 scores (E,) / (E, H), with the source
  rows gathered inside the kernel, or ``<msg[e], x_dst[d]>`` for per-edge
  rows ``msg`` already in CSR order.

The TPU kernels pick destination rows out of dense (R, F) blocks with
one-hot matmuls, so that no second pass through the gather engine is
needed. On the card (``csrc/sddmm_csr.cu``) both kernels walk the CSR
kernels' work items cut at `EDGE_SPLIT` edges (`CSRPlan.split_arrays` at
that K), and since every output element belongs to one edge, an item of
a cut row writes its own edges and no fold follows: a hub row is spread
over many items. The expand gives an item one warp, which writes the
item's output, one contiguous run of its edges' rows, in 16-byte stores
at any width C; the SDDMM gives an item a lane group. Per-edge tensors
are in the plan's CSR order; the JAX package's are in its padded or
compact lane order.

Every op is a `torch.autograd.Function`, differentiable once, whose
backward runs kernels too:

* expand: dx = `segment_sum_csr` of the cotangent (the per-edge form of
  ``csrc/spmm_csr.cu``);
* sddmm with per-edge rows: dmsg = the expand kernel scaled per edge and
  head by the cotangent, dx_dst = `segment_sum_csr` weighted by it;
* sddmm with gathered rows: dx_dst = `spmm_csr` weighted by the cotangent,
  dx_src = `spmm_csr` on the plan's transpose (the JAX `_sddmm_fused_bwd`).

Each kernel is a ``torch.library`` op, ``gammagl::expand_dst_csr`` and
``gammagl::sddmm_csr``, whose arguments are the plan's arrays and work
items at `EDGE_SPLIT`: on a CUDA tensor it launches its kernel or raises;
on a CPU tensor it runs the plain version. Launches are counted in ``expand_dst_csr.launches``
(scaled expands included) and ``sddmm_csr.launches`` (`sddmm_csr_mh` and
the weight gradient of `segment_sum_csr` and `spmm_csr` included).
"""

import ctypes
import functools
from typing import Optional

import torch

from gammagl_tpu_torch.ops.cuda._build import load_library
from gammagl_tpu_torch.ops.cuda.segment_matmul import (EDGE_SPLIT,
                                                       PlanArrays, _csr_rows,
                                                       _first_order_only,
                                                       _forward, _pad_rows,
                                                       _ptr, _raise_on,
                                                       _weigh)
from gammagl_tpu_torch.ops.cuda.segment_matmul import _kernel as _spmm_kernel

__all__ = ["expand_dst_csr", "sddmm_csr", "sddmm_csr_mh",
           "expand_dst_csr_reference", "sddmm_csr_reference", "EDGE_SPLIT"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def expand_dst_csr_reference(x_dst, plan, scale=None):
    """Plain PyTorch version of the expand: ``x_dst[row(e)]`` (E, C), or,
    with ``scale`` (E, H) f32, that row times ``scale[e, c // (C / H)]``
    in float32, rounded once to x_dst's dtype."""
    out = x_dst[_csr_rows(plan, x_dst.device)]
    if scale is None:
        return out
    return _weigh(out.float(), scale).to(x_dst.dtype)


def sddmm_csr_reference(a, x_dst, plan, heads, gather):
    """Plain PyTorch version of the SDDMM: (E, heads) float32 per-head dots
    of ``a[col[e]]`` (``gather``) or ``a[e]`` with ``x_dst[row(e)]``."""
    E = plan.num_edges
    rows = a[plan.arrays(a.device)[1].long()] if gather else a[:E]
    xd = x_dst[_csr_rows(plan, x_dst.device)]
    shape = (E, heads, a.shape[1] // heads)
    return (rows.float().view(shape) * xd.float().view(shape)).sum(-1)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library()
    expand = lib.gammagl_expand_csr
    expand.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                       + [ctypes.c_void_p] + [ctypes.c_int64] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
    expand.restype = ctypes.c_int
    sddmm = lib.gammagl_sddmm_csr
    sddmm.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                      + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
                      + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    sddmm.restype = ctypes.c_int
    return expand, sddmm, _spmm_kernel()[1]


def _check_cuda(op, *tensors):
    """Device, dtype and contiguity of the kernel's row operands."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{op}: inputs on {t.device} and {first.device}")
        if t.dtype not in _KERNEL_DTYPES or t.dtype != first.dtype:
            raise TypeError(f"{op}: dtype {t.dtype} is not one of "
                            f"{_KERNEL_DTYPES}, the same for every operand")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operands must be contiguous")


def _edge_items(plan, device):
    """rowptr, col and the work items at `EDGE_SPLIT` (item_ptr None for a
    plan whose items are its rows): the plan's arguments of the expand
    and the SDDMM ops."""
    rowptr, col, _ = plan.arrays(device)
    item_ptr, meta, _, _, _ = plan.split_arrays(device, EDGE_SPLIT)
    return rowptr, col, None if meta is None else item_ptr, meta


def _check_device(op, device):
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {device}")


def _expand(x, plan, scale=None):
    """x (N_dst, C) -> (E, C) of x's dtype in CSR order, optionally scaled
    per edge and head by ``scale`` (E, H) f32: the op
    ``gammagl::expand_dst_csr``, whose CPU implementation is the plain
    version and whose CUDA one launches the kernel, one warp for each work
    item of the plan at `EDGE_SPLIT` edges, or raises."""
    _check_device("expand_dst_csr", x.device)
    return torch.ops.gammagl.expand_dst_csr(x, scale,
                                            *_edge_items(plan, x.device))


@torch.library.custom_op("gammagl::expand_dst_csr", mutates_args=())
def _expand_op(x: torch.Tensor, scale: Optional[torch.Tensor],
               rowptr: torch.Tensor, col: torch.Tensor,
               item_ptr: Optional[torch.Tensor],
               item_meta: Optional[torch.Tensor]) -> torch.Tensor:
    """``x[row(e)]`` (times ``scale[e, h]``) for every CSR edge e of the
    plan's arrays, the items at `EDGE_SPLIT`."""
    raise ValueError(f"gammagl::expand_dst_csr: no kernel for device "
                     f"{x.device}")


@_expand_op.register_kernel("cpu")
def _expand_cpu(x, scale, rowptr, col, item_ptr, item_meta):
    return expand_dst_csr_reference(x, PlanArrays(rowptr, col), scale)


@_expand_op.register_kernel("cuda")
def _expand_cuda(x, scale, rowptr, col, item_ptr, item_meta):
    _check_cuda("expand_dst_csr", x)
    heads = 1
    if scale is not None:
        if scale.device != x.device or scale.dtype != torch.float32:
            raise TypeError("expand_dst_csr: scale must be float32 on "
                            f"{x.device}")
        scale = scale.contiguous()
        heads = scale.shape[1]
    out = torch.empty(col.shape[0], x.shape[1], dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn, _, err = _kernels()
    n_items = rowptr.shape[0] - 1 if item_meta is None else item_meta.shape[0]
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), _ptr(scale),
                  (rowptr if item_ptr is None else item_ptr).data_ptr(),
                  _ptr(item_meta), n_items, out.data_ptr(), x.shape[1], heads,
                  int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(code, "expand_dst_csr", err)
    expand_dst_csr.launches += 1
    return out


@_expand_op.register_fake
def _expand_fake(x, scale, rowptr, col, item_ptr, item_meta):
    return x.new_empty(col.shape[0], x.shape[1])


def _sddmm(a, x_dst, plan, heads, gather):
    """(E, heads) float32 scores in CSR order: per-head dots of ``a[col[e]]``
    (``gather``: node rows) or ``a[e]`` (per-edge rows) with
    ``x_dst[row(e)]``, the op ``gammagl::sddmm_csr``: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if a.device != x_dst.device:
        raise ValueError(f"sddmm_csr: inputs on {a.device} and "
                         f"{x_dst.device}")
    _check_device("sddmm_csr", a.device)
    return torch.ops.gammagl.sddmm_csr(a, x_dst, *_edge_items(plan, a.device),
                                       int(heads), bool(gather))


@torch.library.custom_op("gammagl::sddmm_csr", mutates_args=())
def _sddmm_op(a: torch.Tensor, x_dst: torch.Tensor, rowptr: torch.Tensor,
              col: torch.Tensor, item_ptr: Optional[torch.Tensor],
              item_meta: Optional[torch.Tensor], heads: int,
              gather: bool) -> torch.Tensor:
    """Per-head dots of ``a[col[e]]`` (``gather``) or ``a[e]`` with
    ``x_dst[row(e)]`` on the plan's arrays, the items at `EDGE_SPLIT`."""
    raise ValueError(f"gammagl::sddmm_csr: no kernel for device {a.device}")


@_sddmm_op.register_kernel("cpu")
def _sddmm_cpu(a, x_dst, rowptr, col, item_ptr, item_meta, heads, gather):
    return sddmm_csr_reference(a, x_dst, PlanArrays(rowptr, col), heads,
                               gather)


@_sddmm_op.register_kernel("cuda")
def _sddmm_cuda(a, x_dst, rowptr, col, item_ptr, item_meta, heads, gather):
    _check_cuda("sddmm_csr", a, x_dst)
    out = torch.empty(col.shape[0], heads, device=a.device)
    if out.numel() == 0:
        return out
    _, fn, err = _kernels()
    n_items = rowptr.shape[0] - 1 if item_meta is None else item_meta.shape[0]
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), x_dst.data_ptr(),
                  (rowptr if item_ptr is None else item_ptr).data_ptr(),
                  _ptr(item_meta), n_items, col.data_ptr(), out.data_ptr(),
                  heads, a.shape[1] // heads, int(gather),
                  int(a.dtype == torch.bfloat16),
                  torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(code, "sddmm_csr", err)
    sddmm_csr.launches += 1
    return out


@_sddmm_op.register_fake
def _sddmm_fake(a, x_dst, rowptr, col, item_ptr, item_meta, heads, gather):
    return a.new_empty(col.shape[0], heads, dtype=torch.float32)


class _Expand(torch.autograd.Function):
    """x_dst (N, C) -> x_dst[row(e)] (E, C); dx = `segment_sum_csr` of the
    cotangent with unit weights (the kernel's per-edge form)."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.n_rows = plan, x.shape[0]
        return _expand(x, plan)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("expand_dst_csr")
        d = _forward(g.contiguous(), None, ctx.plan, per_edge=True)
        return _pad_rows(d, ctx.n_rows), None


class _SddmmEdge(torch.autograd.Function):
    """msg (E, H*F) per-edge rows, x_dst (N, H*F) -> (E, H) f32. dmsg =
    the expand of x_dst scaled by the cotangent; dx_dst = the per-edge
    segment sum of msg weighted by it (`_sddmm_inner_mh_bwd`, one launch
    for all heads)."""

    @staticmethod
    def forward(ctx, msg, x_dst, plan, heads):
        ctx.save_for_backward(msg, x_dst)
        ctx.plan = plan
        return _sddmm(msg, x_dst, plan, heads, gather=False)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("sddmm_csr")
        msg, x_dst = ctx.saved_tensors
        plan, g = ctx.plan, g.float().contiguous()
        dmsg = dxd = None
        if ctx.needs_input_grad[0]:
            dmsg = _expand(x_dst, plan, scale=g)
        if ctx.needs_input_grad[1]:
            dxd = _pad_rows(_forward(msg, g, plan, per_edge=True),
                            x_dst.shape[0])
        return dmsg, dxd, None, None


class _SddmmGather(torch.autograd.Function):
    """x_src (N_src, H*F), x_dst (N, H*F) -> (E, H) f32, the source rows
    gathered in the kernel. Both gradients are SpMMs weighted by the
    cotangent (`_sddmm_fused_bwd`): dx_dst on the plan, dx_src on its
    transpose with the weights carried into its order."""

    @staticmethod
    def forward(ctx, x_src, x_dst, plan, heads):
        ctx.save_for_backward(x_src, x_dst)
        ctx.plan = plan
        return _sddmm(x_src, x_dst, plan, heads, gather=True)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("sddmm_csr")
        x_src, x_dst = ctx.saved_tensors
        plan, g = ctx.plan, g.float().contiguous()
        dxs = dxd = None
        if ctx.needs_input_grad[0]:
            tp = plan.transpose()
            g_t = g[tp.arrays(g.device)[2]]
            dxs = _pad_rows(_forward(x_dst, g_t, tp), x_src.shape[0])
        if ctx.needs_input_grad[1]:
            dxd = _pad_rows(_forward(x_src, g, plan), x_dst.shape[0])
        return dxs, dxd, None, None


def expand_dst_csr(x_dst, plan, interpret=False, compact=False):
    """``x_dst[row(e)]`` for every CSR edge e: (N_dst, ...) -> (E, ...) of
    x_dst's dtype, in the plan's CSR order.

    ``interpret`` and ``compact`` are the JAX package's TPU keywords (its
    compact order is the dst-sorted order, which is this CSR order); they
    are accepted and ignored. On a CUDA tensor the expand kernel copies
    the bits (bitwise equal to ``x_dst[row]``); the backward is
    `segment_sum_csr` of the cotangent. Differentiable once.
    """
    del interpret, compact
    if x_dst.shape[0] < plan.num_nodes:
        raise ValueError(f"x_dst has {x_dst.shape[0]} rows, the plan has "
                         f"{plan.num_nodes}")
    x = x_dst.flatten(1).contiguous()
    out = _Expand.apply(x, plan)
    return out.view((plan.num_edges,) + tuple(x_dst.shape[1:]))


expand_dst_csr.launches = 0


def _scores(x_src, x_dst, plan, msg, heads):
    """Promote the operands to one dtype, flatten the heads, check the
    shapes and run the gathered or the per-edge op; (E, heads)."""
    rows = x_src if msg is None else msg
    dtype = torch.promote_types(rows.dtype, x_dst.dtype)
    xd = x_dst.flatten(1).to(dtype).contiguous()
    a = rows.flatten(1).to(dtype).contiguous()
    if a.shape[1] != xd.shape[1] or xd.shape[1] % heads:
        raise ValueError(f"widths {a.shape[1]} and {xd.shape[1]} differ or "
                         f"are not {heads} heads")
    if xd.shape[0] < plan.num_nodes:
        raise ValueError(f"x_dst has {xd.shape[0]} rows, the plan has "
                         f"{plan.num_nodes}")
    if msg is None:
        if a.shape[0] < plan.num_src:
            raise ValueError(f"x_src has {a.shape[0]} rows, the plan reads "
                             f"{plan.num_src}")
        return _SddmmGather.apply(a, xd, plan, heads)
    if a.shape[0] != plan.num_edges:
        raise ValueError(f"msg has {a.shape[0]} rows, the plan has "
                         f"{plan.num_edges} edges")
    return _SddmmEdge.apply(a, xd, plan, heads)


def sddmm_csr(x_src, x_dst, plan, interpret=False, msg=None):
    """Per-edge dots ``<x_src[src_e], x_dst[dst_e]>``: (E,) float32 in the
    plan's CSR order.

    x_src (N_src, F), x_dst (N_dst, F), float32 or bfloat16 (promoted to
    one dtype). Without ``msg`` the kernel gathers the source rows itself;
    with ``msg`` (E, F), per-edge rows in CSR order, it reads those instead
    and x_src is not used. ``interpret`` is the JAX package's keyword,
    ignored. Differentiable once in every tensor argument.
    """
    del interpret
    return _scores(x_src, x_dst, plan, msg, 1)[:, 0]


sddmm_csr.launches = 0


def sddmm_csr_mh(x_src, x_dst, plan, interpret=False, msg=None):
    """Multi-head `sddmm_csr`: x_src (N_src, H, F), x_dst (N_dst, H, F), or
    msg (E, H, F) -> (E, H) float32, every head in one launch."""
    del interpret
    return _scores(x_src, x_dst, plan, msg, x_dst.shape[1])
