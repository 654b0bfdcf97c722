"""Fused edge attention: score -> per-destination softmax -> weighted sum.

PyTorch counterpart of `gammagl_tpu/ops/pallas/flash_attention.py`. For
each destination row d, head h and edge e of d in the plan's CSR:

    s_e    = leaky_relu(score_e + a_dst[d], slope)
    out[d] = sum_e softmax_d(s)_e * keep_e * msg_e

``keep`` is the fused form of attention dropout: values {0, 1/(1-rate)}
that scale alpha after the softmax, so the denominator keeps the full
mass. It takes no gradient.

On a CUDA tensor the forward launches the hand-written kernel of
``csrc/flash_attention.cu`` and saves the row statistics (m, l); the
backward launches its backward kernel, which recomputes alpha from them.
The op is differentiable once: a backward with ``create_graph=True``
raises on every device.
Both are ``torch.library`` ops, ``gammagl::flash_forward`` (the fold
inside) and ``gammagl::flash_backward``, on the plan's arrays. Launches
are counted in ``flash_forward.launches`` and
``flash_backward.launches``. On a CPU tensor both run their plain
versions, `flash_forward_reference` and `flash_backward_reference`.

The forward walks the CSR kernel's work items (`CSRPlan.split_arrays`): a
row of more than `ROW_SPLIT` edges is cut into items, whose partial
(m, l, sum) triples `flash_fwd_fold` merges in item order (counted in
``flash_fwd_fold.launches``). A plan without cut rows launches no fold.

Per-edge tensors are in the plan's CSR order (the JAX package's are in
its padded lane order). `flash_gat_attention` takes node rows instead:
the kernel gathers ``score`` and ``msg`` at each edge's source. The
gradients of both reach the source rows through `spmm_csr` on
`CSRPlan.edge_scatter_plan` (the counterpart of `gather_rows`' VJP,
`segment_matmul.py:496-515`): no atomic add, so a backward repeats
bitwise.

The order of ``keep`` follows from ``gather``: with per-edge inputs it is
in CSR order, like them; with node rows (``gather``) it is in the caller's
edge order, and the kernels read it through the plan's ``perm``.
"""

import ctypes
import functools
import math
from typing import Optional

import torch

from gammagl_tpu_torch.ops.cuda._build import load_library
from gammagl_tpu_torch.ops.cuda.segment_matmul import _csr_rows
from gammagl_tpu_torch.ops.cuda.segment_matmul import _first_order_only
from gammagl_tpu_torch.ops.cuda.segment_matmul import _kernel as _spmm_kernel
from gammagl_tpu_torch.ops.cuda.segment_matmul import (PlanArrays, _items,
                                                       _op_args, _pad_rows,
                                                       _part_stride,
                                                       _raise_on, _slots,
                                                       spmm_csr)
from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["attention_keep_mask", "flash_edge_attention",
           "flash_edge_attention_mh", "flash_softmax_spmm",
           "flash_softmax_spmm_mh", "flash_gat_attention", "flash_forward",
           "flash_backward", "flash_fwd_fold", "flash_forward_reference",
           "flash_backward_reference"]

_NEG = -1e30  # the row max before any edge, as in the JAX kernels
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def attention_keep_mask(generator, rate, shape, device=None):
    """Pre-scaled dropout weights for ``keep``: {0, 1/(1-rate)} float32
    of ``shape``, each kept with probability 1 - rate, drawn from
    ``generator`` (None: the default generator of the device). ``device``
    None means the generator's device, and without a generator the current
    CUDA card (`utils.device.resolve_device`, which raises when torch sees
    none): the mask is drawn on the host only when asked for."""
    if device is None:
        device = (generator.device if generator is not None
                  else resolve_device(None))
    kp = 1.0 - rate
    u = torch.rand(shape, generator=generator, device=device)
    return (u < kp).float() / kp


def _csr_keep(keep, plan, gather):
    """keep as float32 in CSR order, or None."""
    if keep is None:
        return None
    keep = keep.float()
    return keep[plan.arrays(keep.device)[2]] if gather else keep


def _scores(score, a_dst, plan, gather, slope):
    """(s before the leak, s) per CSR edge, float32 (E, H), and the rows."""
    rows = _csr_rows(plan, score.device)
    col = plan.arrays(score.device)[1].long()
    s = score.float()[col] if gather else score.float()
    if a_dst is not None:
        s = s + a_dst.float()[rows]
    return s, torch.where(s >= 0, s, slope * s), rows, col


def flash_forward_reference(score, a_dst, msg, keep, plan, slope, gather):
    """Plain PyTorch forward: returns (out (N_dst, H*F) of msg's dtype,
    m (N_dst, H), l (N_dst, H)), sums in float32."""
    H = score.shape[1]
    keep = _csr_keep(keep, plan, gather)
    _, s, rows, col = _scores(score, a_dst, plan, gather, slope)
    N, E = plan.num_nodes, plan.num_edges
    m = torch.full((N, H), _NEG, device=s.device).scatter_reduce_(
        0, rows[:, None].expand(E, H), s, "amax")
    p = torch.exp(s - m[rows])
    l = torch.zeros(N, H, device=s.device).index_add_(0, rows, p)
    if keep is not None:
        p = p * keep
    rows_msg = msg[col] if gather else msg
    msgf = rows_msg.float().view(E, H, msg.shape[1] // H)
    acc = torch.zeros(N, H, msgf.shape[2], device=s.device).index_add_(
        0, rows, p[:, :, None] * msgf)
    out = acc / l.clamp_min(1e-16)[:, :, None]
    return out.to(msg.dtype).view(N, msg.shape[1]), m, l


def flash_backward_reference(score, a_dst, msg, keep, m, l, out, grad, plan,
                             slope, gather):
    """Plain PyTorch backward: returns (ds (E, H) f32 and dmsg (E, H*F) of
    msg's dtype, both in CSR order, and da (N_dst, H) f32)."""
    H = score.shape[1]
    keep = _csr_keep(keep, plan, gather)
    s_pre, s, rows, col = _scores(score, a_dst, plan, gather, slope)
    N, E = plan.num_nodes, plan.num_edges
    alpha = (torch.exp(torch.clamp_max(s - m[rows], 0.0))
             / l.clamp_min(1e-16)[rows])
    F = msg.shape[1] // H
    gf = grad.float().view(N, H, F)
    c = (out.float().view(N, H, F) * gf).sum(-1)
    msgf = (msg[col] if gather else msg).float().view(E, H, F)
    dalpha = (gf[rows] * msgf).sum(-1)
    aw = alpha
    if keep is not None:
        dalpha = dalpha * keep
        aw = alpha * keep
    ds = alpha * (dalpha - c[rows]) * torch.where(s_pre >= 0, 1.0, slope)
    da = torch.zeros(N, H, device=s.device).index_add_(0, rows, ds)
    dmsg = (aw[:, :, None] * gf[rows]).to(msg.dtype).view(E, H * F)
    return ds, dmsg, da


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = load_library()
    fwd = lib.gammagl_flash_attention_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                    + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    fwd.restype = ctypes.c_int
    fold = lib.gammagl_flash_attention_fwd_fold
    fold.argtypes = ([ctypes.c_void_p, ctypes.c_int64]
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                     + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2
                     + [ctypes.c_int, ctypes.c_void_p])
    fold.restype = ctypes.c_int
    bwd = lib.gammagl_flash_attention_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 14
                    + [ctypes.c_int64] * 3
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    return fwd, fold, bwd, _spmm_kernel()[1]


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _keep_row(keep, perm, gather):
    """The keep_row pointer: the plan's perm for a mask in the caller's
    edge order (``gather``), else 0 (keep in CSR order, or no keep)."""
    if keep is None or not gather:
        return 0
    return perm.data_ptr()


def _check(score, a_dst, msg, keep, plan, gather):
    """Validate shapes, dtypes, devices and contiguity for both the kernel
    and the plain version; returns (H, F)."""
    if score.dim() != 2 or msg.dim() != 2:
        raise ValueError(f"score must be (rows, H) and msg (rows, H*F), got "
                         f"{tuple(score.shape)} and {tuple(msg.shape)}")
    H = score.shape[1]
    if H < 1 or msg.shape[1] % H or msg.shape[1] == 0:
        raise ValueError(f"msg width {msg.shape[1]} is not H*F for H={H}")
    for name, t in (("score", score), ("msg", msg)):
        if gather and t.shape[0] < plan.num_src:
            raise ValueError(f"{name} has {t.shape[0]} rows, the plan reads "
                             f"{plan.num_src}")
        if not gather and t.shape[0] != plan.num_edges:
            raise ValueError(f"{name} has {t.shape[0]} rows, the plan has "
                             f"{plan.num_edges} edges")
    if a_dst is not None and tuple(a_dst.shape) != (plan.num_nodes, H):
        raise ValueError(f"a_dst shape {tuple(a_dst.shape)} != "
                         f"({plan.num_nodes}, {H})")
    if keep is not None and tuple(keep.shape) != (plan.num_edges, H):
        raise ValueError(f"keep shape {tuple(keep.shape)} != "
                         f"({plan.num_edges}, {H})")
    for t in (score, a_dst, msg, keep):
        if t is not None and t.device != msg.device:
            raise ValueError(f"inputs on {t.device} and {msg.device}")
    if msg.device.type == "cuda":
        if msg.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"flash attention: msg dtype {msg.dtype} is not "
                            f"one of {_KERNEL_DTYPES}")
        for t in (score, a_dst, keep):
            if t is not None and (t.dtype != torch.float32
                                  or not t.is_contiguous()):
                raise TypeError("flash attention: score, a_dst and keep "
                                "must be contiguous float32")
        if not msg.is_contiguous():
            raise ValueError("flash attention: msg must be contiguous")
    elif msg.device.type != "cpu":
        raise ValueError(f"flash attention: no kernel for device "
                         f"{msg.device}")
    return H, msg.shape[1] // H


def _plan_args(plan, device):
    """The plan's arguments of the flash ops: rowptr, col, perm and the
    work items at `ROW_SPLIT` (`_op_args`)."""
    rowptr, col, item_ptr, meta, cut_row, cut_ptr, n_slots = _op_args(
        plan, device)
    return (rowptr, col, plan.arrays(device)[2], item_ptr, meta, cut_row,
            cut_ptr, n_slots)


def flash_forward(score, a_dst, msg, keep, plan, slope, gather):
    """One forward: (out (N_dst, H*F), m, l), the op
    ``gammagl::flash_forward``. A CPU tensor takes
    `flash_forward_reference`; a CUDA tensor launches the kernel, and
    `flash_fwd_fold` after it on a plan with cut rows, or raises."""
    _check(score, a_dst, msg, keep, plan, gather)
    return torch.ops.gammagl.flash_forward(
        score, a_dst, msg, keep, *_plan_args(plan, msg.device), float(slope),
        bool(gather))


@torch.library.custom_op("gammagl::flash_forward", mutates_args=())
def _flash_forward_op(score: torch.Tensor, a_dst: Optional[torch.Tensor],
                      msg: torch.Tensor, keep: Optional[torch.Tensor],
                      rowptr: torch.Tensor, col: torch.Tensor,
                      perm: torch.Tensor, item_ptr: Optional[torch.Tensor],
                      item_meta: Optional[torch.Tensor],
                      cut_row: Optional[torch.Tensor],
                      cut_ptr: Optional[torch.Tensor], n_slots: int,
                      slope: float, gather: bool
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, m, l) of the fused attention on the plan's arrays."""
    raise ValueError(f"gammagl::flash_forward: no kernel for device "
                     f"{msg.device}")


@_flash_forward_op.register_kernel("cpu")
def _flash_forward_cpu(score, a_dst, msg, keep, rowptr, col, perm, item_ptr,
                       item_meta, cut_row, cut_ptr, n_slots, slope, gather):
    return flash_forward_reference(score, a_dst, msg, keep,
                                   PlanArrays(rowptr, col, perm), slope,
                                   gather)


@_flash_forward_op.register_kernel("cuda")
def _flash_forward_cuda(score, a_dst, msg, keep, rowptr, col, perm,
                        item_ptr, item_meta, cut_row, cut_ptr, n_slots,
                        slope, gather):
    plan = PlanArrays(rowptr, col, perm, item_ptr, item_meta, cut_row,
                      cut_ptr, n_slots)
    H = score.shape[1]
    F = msg.shape[1] // H
    dev = msg.device
    N = plan.num_nodes
    out = torch.empty(N, H * F, dtype=msg.dtype, device=dev)
    m = torch.empty(N, H, device=dev)
    l = torch.empty(N, H, device=dev)
    if N == 0:
        return out, m, l
    # a cut row's slot: its partial sums, then m and l of each head
    width = H * F + 2 * H
    part = _slots(plan, width, dev)
    fwd, _, _, err = _kernels()
    with torch.cuda.device(dev):
        code = fwd(msg.data_ptr(), score.data_ptr(), _ptr(a_dst), _ptr(keep),
                   _keep_row(keep, perm, gather), *_items(plan, dev),
                   _ptr(part), _part_stride(width), out.data_ptr(),
                   m.data_ptr(), l.data_ptr(), H, F, float(slope),
                   int(gather), int(msg.dtype == torch.bfloat16),
                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "flash attention forward", err)
    flash_forward.launches += 1
    if part is not None:
        flash_fwd_fold(part, plan, out, m, l)
    return out, m, l


@_flash_forward_op.register_fake
def _flash_forward_fake(score, a_dst, msg, keep, rowptr, col, perm,
                        item_ptr, item_meta, cut_row, cut_ptr, n_slots,
                        slope, gather):
    N, H = rowptr.shape[0] - 1, score.shape[1]
    return (msg.new_empty(N, msg.shape[1]),
            score.new_empty(N, H, dtype=torch.float32),
            score.new_empty(N, H, dtype=torch.float32))


def flash_fwd_fold(part, plan, out, m, l):
    """The forward's second pass on a plan with cut rows: each cut row's
    partials in ``part`` (per item: its f32 sums, then m and l of each
    head) merged in item order by the walk's recurrence (m = max_i m_i,
    l and the sums each rescaled by exp(m_i - m)) into the row's ``out``
    (divided by max(l, 1e-16)), ``m`` and ``l``. The forward calls it
    after its launch; it launches the fold kernel (counted in
    ``flash_fwd_fold.launches``)."""
    _, fold, _, err = _kernels()
    _, _, cut_row, cut_ptr, _ = plan.split_arrays(out.device)
    H = m.shape[1]
    with torch.cuda.device(out.device):
        code = fold(part.data_ptr(), part.shape[1], cut_row.data_ptr(),
                    cut_ptr.data_ptr(), cut_row.shape[0], out.data_ptr(),
                    m.data_ptr(), l.data_ptr(), H, out.shape[1] // H,
                    int(out.dtype == torch.bfloat16),
                    torch.cuda.current_stream(out.device).cuda_stream)
    _raise_on(code, "flash_fwd_fold", err)
    flash_fwd_fold.launches += 1
    return out, m, l


def flash_backward(score, a_dst, msg, keep, m, l, out, grad, plan, slope,
                   gather):
    """One backward: (ds (E, H), dmsg (E, H*F), da (N_dst, H)), per-edge
    outputs in CSR order, the op ``gammagl::flash_backward``. A CPU tensor
    takes `flash_backward_reference`; a CUDA tensor launches the kernel or
    raises."""
    _check(score, a_dst, msg, keep, plan, gather)
    rowptr, col, perm = plan.arrays(msg.device)
    return torch.ops.gammagl.flash_backward(
        score, a_dst, msg, keep, m, l, out, grad, rowptr, col, perm,
        float(slope), bool(gather))


@torch.library.custom_op("gammagl::flash_backward", mutates_args=())
def _flash_backward_op(score: torch.Tensor, a_dst: Optional[torch.Tensor],
                       msg: torch.Tensor, keep: Optional[torch.Tensor],
                       m: torch.Tensor, l: torch.Tensor, out: torch.Tensor,
                       grad: torch.Tensor, rowptr: torch.Tensor,
                       col: torch.Tensor, perm: torch.Tensor, slope: float,
                       gather: bool
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ds, dmsg, da) of the fused attention on the plan's arrays."""
    raise ValueError(f"gammagl::flash_backward: no kernel for device "
                     f"{msg.device}")


@_flash_backward_op.register_kernel("cpu")
def _flash_backward_cpu(score, a_dst, msg, keep, m, l, out, grad, rowptr,
                        col, perm, slope, gather):
    return flash_backward_reference(score, a_dst, msg, keep, m, l, out, grad,
                                    PlanArrays(rowptr, col, perm), slope,
                                    gather)


@_flash_backward_op.register_kernel("cuda")
def _flash_backward_cuda(score, a_dst, msg, keep, m, l, out, grad, rowptr,
                         col, perm, slope, gather):
    H = score.shape[1]
    F = msg.shape[1] // H
    dev = msg.device
    grad = grad.to(msg.dtype).contiguous()
    N, E = rowptr.shape[0] - 1, col.shape[0]
    ds = torch.empty(E, H, device=dev)
    dmsg = torch.empty(E, H * F, dtype=msg.dtype, device=dev)
    da = torch.empty(N, H, device=dev)
    if N == 0:
        return ds, dmsg, da
    _, _, bwd, err = _kernels()
    with torch.cuda.device(dev):
        code = bwd(msg.data_ptr(), score.data_ptr(), _ptr(a_dst), _ptr(keep),
                   _keep_row(keep, perm, gather), rowptr.data_ptr(),
                   col.data_ptr(), m.data_ptr(), l.data_ptr(),
                   out.data_ptr(), grad.data_ptr(),
                   ds.data_ptr(), da.data_ptr(), dmsg.data_ptr(), N, H, F,
                   float(slope), int(gather),
                   int(msg.dtype == torch.bfloat16),
                   torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(code, "flash attention backward", err)
    flash_backward.launches += 1
    return ds, dmsg, da


@_flash_backward_op.register_fake
def _flash_backward_fake(score, a_dst, msg, keep, m, l, out, grad, rowptr,
                         col, perm, slope, gather):
    N, E, H = rowptr.shape[0] - 1, col.shape[0], score.shape[1]
    return (score.new_empty(E, H, dtype=torch.float32),
            msg.new_empty(E, msg.shape[1]),
            score.new_empty(N, H, dtype=torch.float32))


flash_forward.launches = 0
flash_fwd_fold.launches = 0
flash_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """score, a_dst, msg -> out (N_dst, H*F); keep takes no gradient.

    Forward: one launch of the forward kernel, saving (out, m, l).
    Backward: one launch of the backward kernel. With ``gather`` the
    per-edge gradients go back to their source rows by `spmm_csr` on the
    plan's edge-scatter transpose, the score's (E, H) float32 and the
    features' (E, H*F) alike: two more kernel launches on the card, each
    row summed in CSR order, so a step repeats bitwise (the JAX package
    reduces them with ``segment_sum``)."""

    @staticmethod
    def forward(ctx, score, a_dst, msg, keep, plan, slope, gather):
        out, m, l = flash_forward(score, a_dst, msg, keep, plan, slope,
                                  gather)
        ctx.save_for_backward(score, a_dst, msg, keep, out, m, l)
        ctx.plan, ctx.slope, ctx.gather = plan, slope, gather
        return out

    @staticmethod
    def backward(ctx, grad):
        _first_order_only("flash attention")
        score, a_dst, msg, keep, out, m, l = ctx.saved_tensors
        plan, gather = ctx.plan, ctx.gather
        ds, dmsg, da = flash_backward(score, a_dst, msg, keep, m, l, out,
                                      grad, plan, ctx.slope, gather)
        d_score, d_msg = ds, dmsg
        if gather:
            scatter = plan.edge_scatter_plan()
            d_score = _pad_rows(spmm_csr(ds, None, scatter), score.shape[0])
            d_msg = _pad_rows(spmm_csr(dmsg, None, scatter), msg.shape[0])
        return (d_score, None if a_dst is None else da, d_msg, None, None,
                None, None)


def _apply(score, a_dst, msg, keep, plan, slope, gather):
    """Cast the score operands to float32 (autograd sees the casts) and
    run the fused op; returns (N_dst, H, F)."""
    H, width = score.shape[1], math.prod(msg.shape[1:])
    out = _FlashAttention.apply(
        score.float().contiguous(),
        None if a_dst is None else a_dst.float().contiguous(),
        msg.reshape(msg.shape[0], width).contiguous(),
        None if keep is None else keep.detach().float().contiguous(),
        plan, float(slope), gather)
    return out.view(plan.num_nodes, H, width // H)


def flash_gat_attention(s_src, a_dst, x, plan, slope=0.2, keep=None):
    """GAT attention over node rows; the kernel gathers the sources.

      s_src (N_src, H) per-source score, a_dst (N_dst, H) per-destination
      score, x (N_src, H, F) or (N_src, H*F) source features, keep (E, H)
      in the caller's edge order (the kernel reads it through the plan's
      ``perm``) or None  ->  out (N_dst, H, F) of x's dtype.
    """
    return _apply(s_src, a_dst, x, keep, plan, slope, True)


def flash_edge_attention_mh(s_src, a_dst, msg, plan, slope=0.2, keep=None):
    """Multi-head fused attention over per-edge inputs in CSR order:
    s_src (E, H), a_dst (N_dst, H), msg (E, H, F), keep (E, H) or None ->
    out (N_dst, H, F). Counterpart of the JAX ``flash_edge_attention_mh``
    (`flash_attention.py:821-886`) with ``keep`` for ``keep_pad``; any F,
    forward and backward on the kernels."""
    return _apply(s_src, a_dst, msg, keep, plan, slope, False)


def flash_edge_attention(s_src, a_dst, msg, plan, slope=0.2, keep=None):
    """Single head: s_src (E,), a_dst (N_dst,), msg (E, F), keep (E,) or
    None -> out (N_dst, F)."""
    out = _apply(s_src[:, None], a_dst[:, None], msg, None if keep is None
                 else keep[:, None], plan, slope, False)
    return out[:, 0]


def flash_softmax_spmm_mh(scores, msg, plan, keep=None):
    """Softmax of arbitrary per-edge scores (E, H) per destination, then
    the weighted sum of msg (E, H, F): the kernel with slope 1."""
    return _apply(scores, None, msg, keep, plan, 1.0, False)


def flash_softmax_spmm(scores, msg, plan, keep=None):
    """Single head `flash_softmax_spmm_mh`: scores (E,), msg (E, F)."""
    out = _apply(scores[:, None], None, msg, None if keep is None
                 else keep[:, None], plan, 1.0, False)
    return out[:, 0]
