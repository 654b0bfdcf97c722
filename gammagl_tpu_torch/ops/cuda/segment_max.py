"""Segment max and min over a CSR plan: the max-aggregation kernels.

PyTorch counterpart of `gammagl_tpu/ops/pallas/segment_max.py`. For each
destination row d of the plan, over its CSR edges e:

* `spmm_max_csr` / `spmm_min_csr`: ``out[d] = max_e w_e * x[src_e]`` (min),
  the source rows gathered inside the kernel;
* `segment_max_csr` / `segment_min_csr`: ``out[d] = max_e msg[e]`` (min)
  over per-edge rows already in the plan's CSR order.

Exactness is the spec, as in the JAX module: each message is ``w * x``
with the weight rounded to x's dtype, the product rounded to it, and the
result is the winning message bit for bit; the min is ``-max(-msg)``
(negation is exact); a row without edges gives 0, and so does a winner
of -inf (+inf for the min), as under the JAX module's ``where``; its
gradient is then 0 (no message equals the output).

The gradient (`segment_max_bwd`, counterpart of `_segment_max_bwd`) splits
each row's cotangent evenly among the edges whose message equals the
output, per column, and writes the per-edge cotangents in CSR order; the
gathered form then sums them into source rows with `spmm_csr` on the plan's
edge-scatter transpose, the weight folded in, and the weight's own gradient
``<dmsg_e, x[src_e]>`` comes from the same backward kernel.

On a CUDA tensor the forward launches the kernel of ``csrc/segment_max.cu``
and the backward its backward kernel, or they raise; on a CPU tensor both
run their plain versions. They are the ``torch.library`` ops
``gammagl::segment_extreme`` (max and min, gathered and per edge) and
``gammagl::segment_max_bwd``, on the plan's arrays; the passes over cut
rows run inside them. Each public function counts its forward launches
in its ``.launches``; the backward counts in ``segment_max_bwd.launches``.
The op is differentiable once: a backward with ``create_graph=True``
raises on every device.

The kernels walk the CSR kernel's work items (`CSRPlan.split_arrays`): a
row of more than `ROW_SPLIT` edges is cut into items. On a plan with cut
rows the forward's partial maxima are folded by `segment_max_fold`, and
the backward first counts the winners of the cut rows' items
(`segment_max_count`) and sums each cut row's counts in item order
(`segment_max_count_fold`); each counts its launches in ``.launches``. A
plan without cut rows launches none of them.
"""

import ctypes
import functools
from math import inf
from typing import Optional

import torch

from gammagl_tpu_torch.ops.cuda._build import load_library
from gammagl_tpu_torch.ops.cuda.segment_matmul import (PlanArrays, _check_x,
                                                       _csr_rows,
                                                       _csr_weights,
                                                       _first_order_only,
                                                       _forward, _items,
                                                       _op_args, _pad_rows,
                                                       _part_stride, _ptr,
                                                       _raise_on, _slots)
from gammagl_tpu_torch.ops.cuda.segment_matmul import _kernel as _spmm_kernel

__all__ = ["spmm_max_csr", "spmm_min_csr", "segment_max_csr",
           "segment_min_csr", "spmm_max_csr_reference",
           "spmm_min_csr_reference", "segment_max_csr_reference",
           "segment_min_csr_reference", "segment_max_bwd",
           "segment_max_bwd_reference", "segment_max_fold",
           "segment_max_count", "segment_max_count_fold"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _messages(x, w, plan, per_edge):
    """(E, F) messages in CSR order and x's dtype: x[col[e]] (or x[e] for
    per-edge rows) times w_e rounded to x's dtype, the product rounded."""
    msg = x if per_edge else x[plan.arrays(x.device)[1].long()]
    if w is not None:
        msg = msg * w.to(x.dtype)[:, None]
    return msg


def _extreme_reference(x, w, plan, per_edge, negate):
    """Plain PyTorch forward: scatter_reduce of the messages into zeros
    without the zeros (include_self=False), so a row without edges keeps
    its 0; a winner of -inf (+inf for the min) becomes 0."""
    msg = _messages(x, w, plan, per_edge)
    rows = _csr_rows(plan, x.device)[:, None].expand_as(msg)
    out = msg.new_zeros(plan.num_nodes, x.shape[1])
    out.scatter_reduce_(0, rows, msg, "amin" if negate else "amax",
                        include_self=False)
    return out.masked_fill_(out == (inf if negate else -inf), 0.0)


def spmm_max_csr_reference(x, edge_weight, plan, weights_padded=False):
    """Plain PyTorch version of `spmm_max_csr`."""
    _check_x(x, plan)
    w = _csr_weights(edge_weight, plan, weights_padded)
    return _extreme_reference(x, w, plan, False, False)


def spmm_min_csr_reference(x, edge_weight, plan, weights_padded=False):
    """Plain PyTorch version of `spmm_min_csr`."""
    _check_x(x, plan)
    w = _csr_weights(edge_weight, plan, weights_padded)
    return _extreme_reference(x, w, plan, False, True)


def segment_max_csr_reference(msg, plan):
    """Plain PyTorch version of `segment_max_csr`."""
    return _extreme_reference(msg, None, plan, True, False)


def segment_min_csr_reference(msg, plan):
    """Plain PyTorch version of `segment_min_csr`."""
    return _extreme_reference(msg, None, plan, True, True)


def segment_max_bwd_reference(x, w, out, grad, plan, per_edge, want_dw):
    """Plain PyTorch backward: (dmsg (E, F) of x's dtype in CSR order, dw
    (E,) float32 or None). Each winner of a row and column (its message
    equals the output) gets g / (number of winners), rounded to x's
    dtype."""
    msg = _messages(x, w, plan, per_edge)
    rows = _csr_rows(plan, x.device)
    eq = msg == out[rows]
    cnt = torch.zeros(plan.num_nodes, x.shape[1], device=x.device)
    cnt.index_add_(0, rows, eq.float())
    share = grad.to(x.dtype).float() / cnt.clamp_min(1.0)
    dmsg = torch.where(eq, share[rows], 0.0).to(x.dtype)
    dw = None
    if want_dw:
        raw = x[plan.arrays(x.device)[1].long()]
        dw = (dmsg.float() * raw.float()).sum(1)
    return dmsg, dw


@functools.lru_cache(maxsize=None)
def _kernels():
    """(forward, fold, backward, count fold, error string) entry points."""
    lib = load_library()
    fwd = lib.gammagl_segment_max_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                    + [ctypes.c_void_p, ctypes.c_int64]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fold = lib.gammagl_segment_max_fold
    fold.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2
                     + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    bwd = lib.gammagl_segment_max_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                    + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    count_fold = lib.gammagl_segment_max_count_fold
    count_fold.argtypes = ([ctypes.c_void_p, ctypes.c_int64]
                           + [ctypes.c_void_p] * 2
                           + [ctypes.c_int64, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p])
    for fn in (fwd, fold, bwd, count_fold):
        fn.restype = ctypes.c_int
    return fwd, fold, bwd, count_fold, _spmm_kernel()[1]


def _check_cuda(op, x, w):
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{op}: dtype {x.dtype} is not one of "
                        f"{_KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError(f"{op}: x must be contiguous")
    if w is not None and w.device != x.device:
        raise ValueError(f"{op}: edge weights on {w.device}, x on "
                         f"{x.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _extreme(x, w, plan, per_edge, negate):
    """The forward, the op ``gammagl::segment_extreme``: a CPU tensor takes
    the plain version; a CUDA tensor launches the kernel (counted in the
    ``.launches`` of `spmm_max_csr`, `spmm_min_csr`, `segment_max_csr` or
    `segment_min_csr`, by ``per_edge`` and ``negate``), and the fold after
    it on a plan with cut rows, or raises."""
    return torch.ops.gammagl.segment_extreme(
        x, w, *_op_args(plan, x.device), bool(per_edge), bool(negate))


def _counter(per_edge, negate):
    """The public function whose ``.launches`` counts this form."""
    return ((segment_min_csr if negate else segment_max_csr) if per_edge
            else (spmm_min_csr if negate else spmm_max_csr))


@torch.library.custom_op("gammagl::segment_extreme", mutates_args=())
def _extreme_op(x: torch.Tensor, w: Optional[torch.Tensor],
                rowptr: torch.Tensor, col: torch.Tensor,
                item_ptr: Optional[torch.Tensor],
                item_meta: Optional[torch.Tensor],
                cut_row: Optional[torch.Tensor],
                cut_ptr: Optional[torch.Tensor], n_slots: int,
                per_edge: bool, negate: bool) -> torch.Tensor:
    """Segment max (``negate``: min) of the messages ``w_e * x[col[e]]``
    (``per_edge``: ``x[e]``) into their rows, on the plan's arrays."""
    raise ValueError(f"gammagl::segment_extreme: no kernel for device "
                     f"{x.device}")


@_extreme_op.register_kernel("cpu")
def _extreme_cpu(x, w, rowptr, col, item_ptr, item_meta, cut_row, cut_ptr,
                 n_slots, per_edge, negate):
    return _extreme_reference(x, w, PlanArrays(rowptr, col), per_edge,
                              negate)


@_extreme_op.register_kernel("cuda")
def _extreme_cuda(x, w, rowptr, col, item_ptr, item_meta, cut_row, cut_ptr,
                  n_slots, per_edge, negate):
    counter = _counter(per_edge, negate)
    _check_cuda(counter.__name__, x, w)
    plan = PlanArrays(rowptr, col, None, item_ptr, item_meta, cut_row,
                      cut_ptr, n_slots)
    F = x.shape[1]
    out = torch.empty(plan.num_nodes, F, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fwd, _, _, _, err = _kernels()
    part = _slots(plan, F, x.device)
    w = None if w is None else w.contiguous()
    with torch.cuda.device(x.device):
        code = fwd(x.data_ptr(), _ptr(w), *_items(plan, x.device),
                   _ptr(part), _part_stride(F), out.data_ptr(), F,
                   int(per_edge), int(negate),
                   int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(code, counter.__name__, err)
    counter.launches += 1
    if part is not None:
        segment_max_fold(part, plan, out, negate)
    return out


@_extreme_op.register_fake
def _extreme_fake(x, w, rowptr, col, item_ptr, item_meta, cut_row, cut_ptr,
                  n_slots, per_edge, negate):
    return x.new_empty(rowptr.shape[0] - 1, x.shape[1])


def segment_max_fold(part, plan, out, negate):
    """The forward's second pass on a plan with cut rows: each cut row of
    ``out`` is the maximum (``negate``: the minimum) over the partials in
    its slots of ``part``, taken in item order, a winner of -inf (+inf)
    giving 0. The forward calls it after its launch; it launches the fold
    kernel (counted in ``segment_max_fold.launches``)."""
    _, fold, _, _, err = _kernels()
    _, _, cut_row, cut_ptr, _ = plan.split_arrays(out.device)
    with torch.cuda.device(out.device):
        code = fold(part.data_ptr(), part.shape[1], cut_row.data_ptr(),
                    cut_ptr.data_ptr(), cut_row.shape[0], out.data_ptr(),
                    out.shape[1], int(negate),
                    int(out.dtype == torch.bfloat16), _stream(out.device))
    _raise_on(code, "segment_max_fold", err)
    segment_max_fold.launches += 1
    return out


def _backward_kernel(op, x, w, out, grad, dmsg, dw, plan, per_edge, part,
                     count):
    """One launch of the backward kernel: dmsg (and dw), or with ``count``
    the tie counts of the items of cut rows into ``part``."""
    _, _, bwd, _, err = _kernels()
    F = x.shape[1]
    with torch.cuda.device(x.device):
        code = bwd(x.data_ptr(), _ptr(w), *_items(plan, x.device),
                   _ptr(part), _part_stride(F), out.data_ptr(), _ptr(grad),
                   _ptr(dmsg), _ptr(dw), F, int(per_edge), int(count),
                   int(x.dtype == torch.bfloat16), _stream(x.device))
    _raise_on(code, op, err)


def segment_max_bwd(x, w, out, grad, plan, per_edge, want_dw):
    """One backward: (dmsg (E, F) of x's dtype in CSR order, dw (E,)
    float32 or None), the op ``gammagl::segment_max_bwd``. A CPU tensor
    takes `segment_max_bwd_reference`; a CUDA tensor launches the kernel
    (counted in ``segment_max_bwd.launches``), after `segment_max_count`
    and `segment_max_count_fold` on a plan with cut rows, or raises."""
    want_dw = bool(want_dw and w is not None)
    dmsg, dw = torch.ops.gammagl.segment_max_bwd(
        x, w, out, grad, *_op_args(plan, x.device), bool(per_edge), want_dw)
    return dmsg, dw if want_dw else None


@torch.library.custom_op("gammagl::segment_max_bwd", mutates_args=())
def _segment_max_bwd_op(x: torch.Tensor, w: Optional[torch.Tensor],
                        out: torch.Tensor, grad: torch.Tensor,
                        rowptr: torch.Tensor, col: torch.Tensor,
                        item_ptr: Optional[torch.Tensor],
                        item_meta: Optional[torch.Tensor],
                        cut_row: Optional[torch.Tensor],
                        cut_ptr: Optional[torch.Tensor], n_slots: int,
                        per_edge: bool, want_dw: bool
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dmsg (E, F), dw: (E,) float32 with ``want_dw``, else (0,)) on the
    plan's arrays."""
    raise ValueError(f"gammagl::segment_max_bwd: no kernel for device "
                     f"{x.device}")


@_segment_max_bwd_op.register_kernel("cpu")
def _segment_max_bwd_cpu(x, w, out, grad, rowptr, col, item_ptr, item_meta,
                         cut_row, cut_ptr, n_slots, per_edge, want_dw):
    dmsg, dw = segment_max_bwd_reference(x, w, out, grad,
                                         PlanArrays(rowptr, col), per_edge,
                                         want_dw)
    return dmsg, dw if want_dw else x.new_empty(0, dtype=torch.float32)


@_segment_max_bwd_op.register_kernel("cuda")
def _segment_max_bwd_cuda(x, w, out, grad, rowptr, col, item_ptr, item_meta,
                          cut_row, cut_ptr, n_slots, per_edge, want_dw):
    _check_cuda("segment_max_bwd", x, w)
    plan = PlanArrays(rowptr, col, None, item_ptr, item_meta, cut_row,
                      cut_ptr, n_slots)
    grad = grad.to(x.dtype).contiguous()
    E, F = plan.num_edges, x.shape[1]
    dmsg = torch.empty(E, F, dtype=x.dtype, device=x.device)
    dw = torch.zeros(E if want_dw else 0, device=x.device)
    if dmsg.numel() == 0:
        return dmsg, dw
    w = None if w is None else w.contiguous()
    total = None
    if plan.split_arrays(x.device)[4]:
        total = segment_max_count_fold(
            segment_max_count(x, w, out, plan, per_edge), plan, F)
    _backward_kernel("segment_max_bwd", x, w, out, grad, dmsg,
                     dw if want_dw else None, plan, per_edge, total, False)
    segment_max_bwd.launches += 1
    return dmsg, dw


@_segment_max_bwd_op.register_fake
def _segment_max_bwd_fake(x, w, out, grad, rowptr, col, item_ptr, item_meta,
                          cut_row, cut_ptr, n_slots, per_edge, want_dw):
    E = col.shape[0]
    return (x.new_empty(E, x.shape[1]),
            x.new_empty(E if want_dw else 0, dtype=torch.float32))


def segment_max_count(x, w, out, plan, per_edge):
    """The backward's first pass on a plan with cut rows: for each item of
    a cut row, how many of its edges win each column (their message equals
    ``out``), float32 (slots, stride), one slot an item in item order
    (launches counted in ``segment_max_count.launches``)."""
    counts = _slots(plan, x.shape[1], x.device)
    _backward_kernel("segment_max_count", x, w, out, None, None, None, plan,
                     per_edge, counts, True)
    segment_max_count.launches += 1
    return counts


def segment_max_count_fold(counts, plan, F):
    """Each cut row's tie counts over F columns summed over its slots in
    item order (exact integers in float32), written to every slot of the
    row in a new tensor like ``counts``; the backward's items of cut rows
    read their row's total there (launches counted in
    ``segment_max_count_fold.launches``)."""
    _, _, _, count_fold, err = _kernels()
    _, _, cut_row, cut_ptr, _ = plan.split_arrays(counts.device)
    total = torch.empty_like(counts)
    with torch.cuda.device(counts.device):
        code = count_fold(counts.data_ptr(), counts.shape[1],
                          cut_row.data_ptr(), cut_ptr.data_ptr(),
                          cut_row.shape[0], total.data_ptr(), F,
                          _stream(counts.device))
    _raise_on(code, "segment_max_count_fold", err)
    segment_max_count_fold.launches += 1
    return total


for _fn in (segment_max_bwd, segment_max_fold, segment_max_count,
            segment_max_count_fold):
    _fn.launches = 0
del _fn


class _SegmentExtreme(torch.autograd.Function):
    """x (node rows, or per-edge rows in CSR order), w (E,) f32 in CSR
    order or None -> (N_dst, F). The backward kernel gives the per-edge
    cotangents (and dw); for node rows `spmm_csr` on the edge-scatter
    transpose sums them, times the weight, into the source rows."""

    @staticmethod
    def forward(ctx, x, w, plan, per_edge, negate):
        out = _extreme(x, w, plan, per_edge, negate)
        ctx.save_for_backward(x, w, out)
        ctx.plan, ctx.per_edge = plan, per_edge
        return out

    @staticmethod
    def backward(ctx, g):
        _first_order_only("segment max")
        x, w, out = ctx.saved_tensors
        plan = ctx.plan
        dmsg, dw = segment_max_bwd(x, w, out, g, plan, ctx.per_edge,
                                   ctx.needs_input_grad[1])
        dx = None
        if ctx.needs_input_grad[0]:
            if ctx.per_edge:
                dx = dmsg
            else:
                scatter = plan.edge_scatter_plan()
                w_t = None
                if w is not None:  # the message's weight, rounded to x's
                    w_t = w.to(x.dtype).float()[
                        scatter.arrays(w.device)[2]]
                dx = _pad_rows(_forward(dmsg, w_t, scatter), x.shape[0])
        return dx, dw, None, None, None


def _gathered(x, edge_weight, plan, weights_padded, negate):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_counter(False, negate).__name__}: no kernel for "
                         f"device {x.device}")
    _check_x(x, plan)
    w = _csr_weights(edge_weight, plan, weights_padded)
    return _SegmentExtreme.apply(x, w, plan, False, negate)


def _per_edge(msg, plan, negate):
    if msg.dim() != 2 or msg.shape[0] != plan.num_edges:
        raise ValueError(f"msg must be (E={plan.num_edges}, F), got "
                         f"{tuple(msg.shape)}")
    if msg.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{_counter(True, negate).__name__}: no kernel for "
                         f"device {msg.device}")
    return _SegmentExtreme.apply(msg, None, plan, True, negate)


def spmm_max_csr(x, edge_weight, plan, weights_padded=False):
    """out[d] = max_{(s,d)} w_sd * x[s] over the plan's edges, exact.

    x : (N_src, F) float32 or bfloat16; the result has x's dtype and is
        the winning message bit for bit; rows without edges are 0.
    edge_weight : (E,) in the caller's edge order, None for unit weights,
        or the output of `pad_edge_weights` with ``weights_padded=True``;
        rounded to x's dtype before the product, as in the JAX module.

    A CPU tensor takes `spmm_max_csr_reference`; a CUDA tensor launches the
    kernel (counted in ``spmm_max_csr.launches``) or raises.
    Differentiable once in x and edge_weight; ties split the cotangent
    evenly.
    """
    return _gathered(x, edge_weight, plan, weights_padded, False)


def spmm_min_csr(x, edge_weight, plan, weights_padded=False):
    """out[d] = min_{(s,d)} w_sd * x[s]: `spmm_max_csr` of the negated
    messages, negated (``spmm_min_csr.launches``)."""
    return _gathered(x, edge_weight, plan, weights_padded, True)


def segment_max_csr(msg, plan):
    """Max of per-edge rows ``msg`` (E, F) in the plan's CSR order into
    their destination rows; rows without edges are 0
    (``segment_max_csr.launches``). Differentiable once."""
    return _per_edge(msg, plan, False)


def segment_min_csr(msg, plan):
    """Min of per-edge rows in CSR order (``segment_min_csr.launches``)."""
    return _per_edge(msg, plan, True)


for _fn in (spmm_max_csr, spmm_min_csr, segment_max_csr, segment_min_csr):
    _fn.launches = 0
del _fn
