"""Destination-sorted CSR SpMM and segment sum: the plan and the kernel's
wrappers.

PyTorch counterpart of `gammagl_tpu/ops/pallas/segment_matmul.py`. The
TPU module tiles a padded, source-blocked layout for its matrix unit and
gather engine. On the card one CSR serves every width and dtype: edges
sorted stably by destination, ``rowptr`` over destination rows, ``col``
the source of each CSR edge, and ``perm`` the position of each CSR edge
in the caller's edge order, so per-edge weights can follow.

`spmm_csr` computes ``out[d] = sum_{(s, d)} w_sd * x[s]``. On a CUDA
tensor it launches the hand-written kernel of ``csrc/spmm_csr.cu`` and
counts the launch in ``spmm_csr.launches``; on a CPU tensor it runs the
plain version, `spmm_csr_reference`. It is differentiable: the gradient
of ``x`` is the same SpMM on the plan's transpose (`CSRPlan.transpose`),
counterpart of `_spmm_fused_bwd` and `_swap_plan` in the JAX module, and
the gradient of the weights is the per-edge rowdot
``<x[src_e], g[dst_e]>``, the SDDMM kernel of ``csrc/sddmm_csr.cu``.

The same kernel reads per-edge rows in CSR order in place of gathered
source rows: `segment_sum_csr` sums them into their destinations, with
weights per edge or per edge and head (counterpart of `segment_sum_csr`
and `segment_sum_win`; launches counted in ``segment_sum_csr.launches``).
`gather_rows` is the per-edge endpoint gather with a kernel-backed
backward. A CSR has no window layout, so the JAX package's padded and
compact edge orders are both the port's CSR order.

`spmm_csr_acc` is the accumulating form, ``out = prev + A x``, which the
planned halo tier (`parallel.halo_plan`) chains over a partition's source
blocks: counterpart of `segment_matmul_dyn_packed` with ``out_acc``, the
same kernel with a flag (launches counted in ``spmm_csr_acc.launches``).
The JAX kernel gathers a pre-packed table of bf16 halves; this one gathers
its own rows in every dtype and width.

On the card a plan's rows are cut into work items of at most `ROW_SPLIT`
edges (`build_row_split`, built once per plan and cached per device by
`CSRPlan.split_arrays`): a hub row of a power-law graph is spread over
many lanes instead of walked by one warp. The partial sums of a cut row
are folded in item order by a second kernel (`csr_fold`, launches counted
in ``csr_fold.launches``), so the result stays deterministic.

Every kernel launch of this package is the CUDA implementation of a
``torch.library`` custom op (registered when its module is imported;
nothing is built until its first CUDA launch): here
``torch.ops.gammagl.spmm_csr`` (the forward of `spmm_csr` and
`segment_sum_csr`) and ``gammagl::spmm_csr_acc`` (with
``gammagl::spmm_csr_acc_out``, which writes into a given tensor). An op's
arguments are tensors, ints, floats and bools: the plan's arrays
(`_op_args`), never the plan; its CPU implementation is the plain
version, its fake implementation gives the output's shape from the
arguments' shapes. Eager calls and `torch.export` take that one route,
so an exported model runs the kernels from a file
(`serve.export_forward`). While a trace runs, a plan caches nothing: its
arrays come from the export wrapper's buffers (`bind_plan_arrays`) or
are built for that trace alone.
"""

import contextlib
import ctypes
import functools
import threading
from collections import namedtuple
from typing import Optional

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda._build import load_library

__all__ = ["CSRPlan", "build_csr_plan", "build_csr_plan_blocked",
           "build_row_split", "RowSplit", "ROW_SPLIT", "csr_fold",
           "pad_edge_weights", "spmm_csr", "spmm_csr_reference",
           "spmm_csr_acc", "spmm_csr_acc_reference", "segment_sum_csr",
           "segment_sum_csr_reference", "gather_rows"]


# The most CSR edges one work item of the kernel walks. A row of more
# edges is cut into ceil(deg / ROW_SPLIT) items whose f32 partial sums the
# fold adds up. Rows of graphs without hubs stay whole (the arxiv-shape
# graph's largest in-degree is ~760): those plans carry no item table and
# launch no fold. On the papers shard's transpose (a hub of 1,401,814
# edges: 685 items) the one-plan call moves by a few percent between K =
# 1024 and 8192 (chip_smoke.py phase 24 times the sweep); smaller items
# leave more slots to fold, larger ones a longer walk on one lane group.
ROW_SPLIT = 2048

# The most CSR edges one work item of the SDDMM or the expand takes
# (`build_row_split` at this K). An item reads its destination row once
# and writes only its own edges' outputs, so short items cost little and
# spread long rows (the arxiv-shape graph's ~800-edge rows, a hub's
# million) over many lane groups or warps, with nothing to fold. Chosen on
# the card from {64, 128, 256, 512, 1024, 2048} for both kernels
# (scripts/sddmm_probe.py times the sweep).
EDGE_SPLIT = 128

# the buffer-name prefix of each item size's work items (`CSRPlan.buffers`)
_SPLIT_NAMES = {ROW_SPLIT: "", EDGE_SPLIT: "edge_"}

RowSplit = namedtuple("RowSplit", [
    "item_ptr",   # (n_items + 1,) int64: item i holds CSR edges
                  # [item_ptr[i], item_ptr[i + 1])
    "item_row",   # (n_items,) int32: the row of each item
    "item_slot",  # (n_items,) int32: scratch slot of an item of a cut row,
                  # -1 for an item that owns its row
    "cut_row",    # (n_cut,) int32: the rows cut into more than one item
    "cut_ptr",    # (n_cut + 1,) int64: cut row i owns slots
                  # [cut_ptr[i], cut_ptr[i + 1]), one per item, in order
])


def build_row_split(rowptr, K=ROW_SPLIT):
    """The kernel's work items for a CSR row pointer, in numpy.

    A row of up to ``K`` edges is one item (an empty row too, so it is
    still written); a longer row is cut into ``ceil(deg / K)`` items of K
    consecutive CSR edges, the last one shorter, each with a scratch slot.
    Items follow CSR order, so ``item_ptr`` ends at the edge count.
    """
    rowptr = np.asarray(rowptr, np.int64)
    K = int(K)
    if K < 1:
        raise ValueError(f"K must be positive, got {K}")
    n_rows = rowptr.shape[0] - 1
    if n_rows >= 2 ** 31:
        raise ValueError(f"{n_rows} rows do not fit the int32 item rows")
    deg = np.diff(rowptr)
    per_row = np.maximum(1, -(-deg // K))
    item_row = np.repeat(np.arange(n_rows, dtype=np.int64), per_row)
    first = np.cumsum(per_row) - per_row  # the first item of each row
    k = np.arange(item_row.shape[0], dtype=np.int64) - first[item_row]
    item_ptr = np.append(rowptr[item_row] + k * K, rowptr[-1])
    cut = per_row > 1
    in_cut = cut[item_row]
    item_slot = np.where(in_cut, np.cumsum(in_cut) - 1, -1)
    cut_ptr = np.zeros(int(cut.sum()) + 1, np.int64)
    np.cumsum(per_row[cut], out=cut_ptr[1:])
    return RowSplit(item_ptr, item_row.astype(np.int32),
                    item_slot.astype(np.int32),
                    np.flatnonzero(cut).astype(np.int32), cut_ptr)


def _tracing():
    """True while `torch.export` or `torch.compile` traces the caller:
    tensors made then are fake or belong to that trace alone."""
    return torch.compiler.is_compiling()


_BOUND = threading.local()


def _bound(plan):
    """The arrays `bind_plan_arrays` gives ``plan`` in this thread, or
    None."""
    return getattr(_BOUND, "plans", {}).get(id(plan))


@contextlib.contextmanager
def bind_plan_arrays(bound):
    """Within the block, each plan of ``bound`` ({plan: the dict of its
    ``buffers``, as buffers of a module}) reads those tensors in a trace,
    in place of its own device copies."""
    before = getattr(_BOUND, "plans", {})
    _BOUND.plans = {**before, **{id(p): b for p, b in bound.items()}}
    try:
        yield
    finally:
        _BOUND.plans = before


class CSRPlan:
    """Destination-sorted CSR of a graph, built once on the host.

    rowptr : (num_nodes + 1,) int64, edges of row d are
             [rowptr[d], rowptr[d + 1])
    col    : (num_edges,) int32, source of each CSR edge
    perm   : (num_edges,) int64, caller's index of each CSR edge

    window : the ``window`` keyword it was built with. It changes no
             layout here; it is kept because the JAX package's layers pick
             a route by it (`HGTConv` fuses on window plans only), so the
             port's take the same route for the same call.

    One copy of the arrays is kept per device (`arrays`), and of the
    kernels' work items per device and item size (`split_arrays`); the
    transpose plans of the backward are built on first use and kept too.
    While a trace runs none of these caches is filled: a tensor made then
    is the trace's own (a fake one in `torch.export`), and a later eager
    call would read it.
    """

    def __init__(self, rowptr, col, perm, num_nodes, num_src, num_edges,
                 window=False):
        self.window = bool(window)
        self.rowptr = rowptr
        self.col = col
        self.perm = perm
        self.num_nodes = int(num_nodes)
        self.num_src = int(num_src)
        self.num_edges = int(num_edges)
        self._placed = {}
        self._split = {}
        self._split_placed = {}
        self._transpose = None
        self._edge_scatter = None

    def transpose(self):
        """The plan of the reverse graph: rows are this plan's sources,
        ``col`` the destination of each edge, and ``perm`` the position of
        each of its edges in THIS plan's CSR order, so weights in CSR
        order follow with ``w[transpose().perm]``."""
        if self._transpose is not None:
            return self._transpose
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int64),
                         np.diff(self.rowptr))
        tp = build_csr_plan(rows, self.col, self.num_src,
                            num_src=self.num_nodes)
        if not _tracing():
            self._transpose = tp
        return tp

    def edge_scatter_plan(self):
        """A plan whose rows are this plan's sources and whose ``col`` is
        the CSR position of each edge: `spmm_csr` with it sums per-edge
        rows, given in this plan's CSR order, into their source rows."""
        if self._edge_scatter is not None:
            return self._edge_scatter
        tp = self.transpose()
        plan = CSRPlan(tp.rowptr, tp.perm.astype(np.int32), tp.perm,
                       self.num_src, self.num_edges, self.num_edges)
        if not _tracing():
            self._edge_scatter = plan
        return plan

    def arrays(self, device):
        """(rowptr, col, perm) as tensors on ``device``, copied once (in a
        trace: the bound buffers, or copies for that trace alone)."""
        device = _placed_device(device)
        if _tracing():
            bound = _bound(self)
            if bound is not None:
                return bound["rowptr"], bound["col"], bound["perm"]
            return tuple(torch.from_numpy(a).to(device)
                         for a in (self.rowptr, self.col, self.perm))
        placed = self._placed.get(device)
        if placed is None:
            # ordinary tensors even when first placed under inference
            # mode, so later autograd code may use the cached copy
            with torch.inference_mode(False):
                placed = self._placed[device] = tuple(
                    torch.from_numpy(a).to(device)
                    for a in (self.rowptr, self.col, self.perm))
        return placed

    def buffers(self, device):
        """The tensors of this plan that the ops read, by name, on
        ``device``: rowptr, col and perm, and the work items at `ROW_SPLIT`
        and at `EDGE_SPLIT` (names ``edge_...``) where it has cut rows. An
        export wrapper registers them as buffers, so the artifact carries
        them (`serve.export_forward`)."""
        out = dict(zip(("rowptr", "col", "perm"), self.arrays(device)))
        for K, prefix in _SPLIT_NAMES.items():
            item_ptr, meta, cut_row, cut_ptr, _ = self.split_arrays(device, K)
            if meta is not None:
                out.update({f"{prefix}item_ptr": item_ptr,
                            f"{prefix}item_meta": meta,
                            f"{prefix}cut_row": cut_row,
                            f"{prefix}cut_ptr": cut_ptr})
        return out

    def row_split(self, K=ROW_SPLIT):
        """The kernels' work items (`build_row_split` at ``K``; the CSR
        kernels take `ROW_SPLIT`), built on first use for each K."""
        split = self._split.get(K)
        if split is None:
            split = self._split[K] = build_row_split(self.rowptr, K)
        return split

    def split_arrays(self, device, K=ROW_SPLIT):
        """The work items at ``K`` as the kernels read them on ``device``,
        copied once for each device and K: (item_ptr, item_meta, cut_row,
        cut_ptr, n_slots). A plan without cut rows has one item per row:
        item_ptr is rowptr itself and the others are None (and 0). In a
        trace: the bound buffers at `ROW_SPLIT` or `EDGE_SPLIT`, or copies
        for that trace alone."""
        device = _placed_device(device)
        tracing = _tracing()
        placed = None if tracing else self._split_placed.get((device, K))
        if placed is not None:
            return placed
        split = self.row_split(K)
        prefix = _SPLIT_NAMES.get(K)
        bound = _bound(self) if tracing and prefix is not None else None
        if split.cut_row.shape[0] == 0:
            placed = (self.arrays(device)[0], None, None, None, 0)
        elif bound is not None:
            placed = tuple(bound[prefix + name] for name in (
                "item_ptr", "item_meta", "cut_row", "cut_ptr")) + (
                    int(split.cut_ptr[-1]),)
        else:
            with torch.inference_mode(False):
                meta = np.stack([split.item_row, split.item_slot], 1)
                placed = tuple(torch.from_numpy(np.ascontiguousarray(a))
                               .to(device) for a in (
                                   split.item_ptr, meta, split.cut_row,
                                   split.cut_ptr)) + (
                                       int(split.cut_ptr[-1]),)
        if not tracing:
            self._split_placed[(device, K)] = placed
        return placed

    def __repr__(self):
        return (f"CSRPlan(N={self.num_nodes}, N_src={self.num_src}, "
                f"E={self.num_edges}, window={self.window})")


def _placed_device(device):
    """``device`` with the current card's index filled in, a cache key."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def build_csr_plan(src, dst, num_nodes, num_src=None, R=None, ET=None,
                   window=None):
    """Build the plan from COO edges on the host, in numpy.

    ``src``/``dst`` need not be sorted. Out-of-range endpoints raise.
    ``R``, ``ET`` and ``window`` are the TPU tiling keywords of the JAX
    package; a CSR needs none of them, so R and ET are ignored and
    ``window`` (None: False, the JAX default) is only kept on the plan.
    """
    del R, ET
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} differ")
    num_nodes = int(num_nodes)
    num_src = int(num_src if num_src is not None else num_nodes)
    if num_src >= 2 ** 31:
        raise ValueError(f"num_src {num_src} does not fit the int32 col")
    E = int(dst.shape[0])
    if E:
        if int(dst.min()) < 0 or int(dst.max()) >= num_nodes:
            raise ValueError(
                f"build_csr_plan: dst out of range [0, {num_nodes}) "
                f"(min {int(dst.min())}, max {int(dst.max())})")
        if int(src.min()) < 0 or int(src.max()) >= num_src:
            raise ValueError(
                f"build_csr_plan: src out of range [0, {num_src}) "
                f"(min {int(src.min())}, max {int(src.max())})")
    perm = np.argsort(dst, kind="stable")
    rowptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=num_nodes), out=rowptr[1:])
    return CSRPlan(rowptr, src[perm].astype(np.int32), perm.astype(np.int64),
                   num_nodes, num_src, E, window=bool(window))


def build_csr_plan_blocked(src, dst, num_nodes, num_src=None, R=None,
                           ET=None, num_src_blocks=None, window=None):
    """The JAX package splits edges by source block to keep each TPU
    gather small. A CSR read by the card needs no split, so this builds
    one `CSRPlan`; the tiling keywords are accepted and ignored."""
    del num_src_blocks
    return build_csr_plan(src, dst, num_nodes, num_src, R=R, ET=ET,
                          window=window)


def pad_edge_weights(plan, edge_weight):
    """Carry caller-order weights (E,) into the plan's CSR order, as
    float32. For weights that are fixed per graph, call this once and
    pass the result with ``weights_padded=True``."""
    if edge_weight.shape != (plan.num_edges,):
        raise ValueError(f"edge_weight shape {tuple(edge_weight.shape)} != "
                         f"({plan.num_edges},)")
    perm = plan.arrays(edge_weight.device)[2]
    return edge_weight.float()[perm]


def _csr_weights(edge_weight, plan, weights_padded):
    """float32 (E,) weights in CSR order, or None for unit weights."""
    if edge_weight is None:
        return None
    if not weights_padded:
        return pad_edge_weights(plan, edge_weight)
    if edge_weight.shape != (plan.num_edges,):
        raise ValueError(f"padded weights shape {tuple(edge_weight.shape)} "
                         f"!= ({plan.num_edges},)")
    return edge_weight.float()


def _check_x(x, plan):
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (N_src, F), got {tuple(x.shape)}")
    if x.shape[0] < plan.num_src:
        raise ValueError(f"x has {x.shape[0]} rows, the plan reads "
                         f"{plan.num_src}")


def _csr_rows(plan, device):
    """The destination row of each CSR edge: (E,) int64 on ``device``."""
    return _rows_of(plan.arrays(device)[0], plan.num_edges)


def _rows_of(rowptr, num_edges):
    """The row of each of ``num_edges`` CSR edges of ``rowptr``."""
    return torch.repeat_interleave(
        torch.arange(rowptr.shape[0] - 1, device=rowptr.device),
        rowptr.diff(), output_size=num_edges)


def _weigh(v, w):
    """v (E, C) times per-edge weights: w (E,) scales a whole row, w (E, H)
    scales the columns of head h, ``c // (C / H) == h``."""
    if w.dim() == 1:
        return v * w[:, None]
    E, H = w.shape
    C = v.shape[1]
    return (v.view(E, H, C // H) * w[:, :, None]).view(E, C)


def _csr_sum_reference(x, w, plan, per_edge, prev=None):
    """Plain PyTorch version of the kernel: ``out[d] = prev[d] + sum_e w_e *
    x[r(e)]`` over the CSR edges of d, with r(e) = e (``per_edge``) or
    col[e], w None, (E,) or (E, H) in CSR order, prev None (0) or (N_dst,
    F); float32 sums from prev, in CSR order, cast once to x's dtype."""
    rowptr, col, _ = plan.arrays(x.device)
    return _csr_sum_arrays(x, w, rowptr, col, per_edge, prev)


def _csr_sum_arrays(x, w, rowptr, col, per_edge, prev=None):
    """`_csr_sum_reference` on the plan's rowptr and col."""
    E = col.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    msg = (x[:E] if per_edge else x[col.long()]).to(acc)
    if w is not None:
        msg = _weigh(msg, w.to(acc))
    if prev is None:
        out = torch.zeros(rowptr.shape[0] - 1, x.shape[1], dtype=acc,
                          device=x.device)
    else:
        out = prev.to(acc, copy=True)
    return out.index_add_(0, _rows_of(rowptr, E), msg).to(x.dtype)


def spmm_csr_reference(x, edge_weight, plan, weights_padded=False):
    """Plain PyTorch version of `spmm_csr`: ``index_add_`` of the weighted
    source rows in float32, cast once to ``x``'s dtype."""
    _check_x(x, plan)
    w = _csr_weights(edge_weight, plan, weights_padded)
    return _csr_sum_reference(x, w, plan, False)


def spmm_csr_acc_reference(x, edge_weight, plan, prev=None,
                           weights_padded=False):
    """Plain PyTorch version of `spmm_csr_acc`: ``prev + A x`` with the
    edges added to prev in float32, in CSR order, cast once to ``x``'s
    dtype (rows without edges keep prev's bits)."""
    _check_x(x, plan)
    _check_prev(prev, x, plan)
    w = _csr_weights(edge_weight, plan, weights_padded)
    return _csr_sum_reference(x, w, plan, False, prev)


def segment_sum_csr_reference(v, plan, w=None):
    """Plain PyTorch version of `segment_sum_csr`."""
    return _csr_sum_reference(v, None if w is None else w.float(), plan, True)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library()
    fn = lib.gammagl_spmm_csr
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]
                   + [ctypes.c_int64] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.gammagl_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.lru_cache(maxsize=None)
def _acc_kernel():
    fn = load_library().gammagl_spmm_csr_acc
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _fold_kernel():
    fn = load_library().gammagl_csr_fold
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int64] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _raise_on(code, what, err):
    """Raise for a nonzero status of a kernel's C entry point (the launch
    was refused: its error string, by ``err``)."""
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err(code).decode()} ({code})")


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launch_arrays(x, w, rowptr, col, item_ptr, meta, cut_row, cut_ptr,
                   n_slots, per_edge=False, prev=None, out=None):
    """Run the kernel on CUDA tensors: x f32 or bf16, (N_src, F) node rows
    or (E, F) per-edge rows (``per_edge``); w f32 (E,) or (E, H) in CSR
    order, or None; with ``prev`` (node rows and (E,) weights only) the
    accumulating form. Writes into ``out`` when given (it may be prev).
    ``item_ptr`` ... ``n_slots`` as `CSRPlan.split_arrays` gives them
    (item_ptr None: an item a row). Counts the launch in `spmm_csr`, per
    edge in `segment_sum_csr`, with prev in `spmm_csr_acc`; a plan with
    cut rows then runs `csr_fold`."""
    op = ("segment_sum_csr" if per_edge else "spmm_csr" if prev is None
          else "spmm_csr_acc")
    if x.device.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{op}: x dtype {x.dtype} is not one of "
                        f"{_KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError(f"{op}: x must be contiguous")
    num_nodes = rowptr.shape[0] - 1
    heads = 1
    if w is not None:
        if w.device != x.device:
            raise ValueError(f"edge weights on {w.device}, x on {x.device}")
        w = w.contiguous()
        heads = 1 if w.dim() == 1 else w.shape[1]
    if out is None:
        out = torch.empty(num_nodes, x.shape[1], dtype=x.dtype,
                          device=x.device)
    if out.numel() == 0:
        return out
    F = x.shape[1]
    if item_ptr is None:
        item_ptr = rowptr
    n_items = num_nodes if meta is None else meta.shape[0]
    stride = _part_stride(F)
    part = (torch.empty(n_slots, stride, dtype=torch.float32,
                        device=x.device) if n_slots else None)
    fn, err = _kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    items = (item_ptr.data_ptr(), _ptr(meta), n_items, col.data_ptr(),
             _ptr(part), stride)
    with torch.cuda.device(x.device):
        if prev is None:
            code = fn(x.data_ptr(), _ptr(w), *items, out.data_ptr(), F,
                      heads, int(per_edge), bf16, stream)
        else:
            code = _acc_kernel()(x.data_ptr(), _ptr(w), *items,
                                 prev.data_ptr(), out.data_ptr(), F, bf16,
                                 stream)
    _raise_on(code, op, err)
    counter = (segment_sum_csr if per_edge else spmm_csr if prev is None
               else spmm_csr_acc)
    counter.launches += 1
    if n_slots:
        csr_fold(part, cut_row, cut_ptr, prev, out)
    return out


def _part_stride(F):
    """Floats a scratch slot takes for F columns: F rounded up to a
    multiple of 4, so every slot starts on 16 bytes."""
    return -(-F // 4) * 4


def _items(plan, device):
    """The kernels' item arguments on ``device``: (item_ptr, item_meta,
    n_items, col) as pointers; item i is row i when the plan has no cut
    rows."""
    item_ptr, meta, _, _, _ = plan.split_arrays(device)
    n_items = plan.num_nodes if meta is None else meta.shape[0]
    return (item_ptr.data_ptr(), _ptr(meta), n_items,
            plan.arrays(device)[1].data_ptr())


def _slots(plan, F, device):
    """A float32 scratch slot of F columns for each item of a cut row, or
    None when the plan has no cut rows."""
    n_slots = plan.split_arrays(device)[4]
    if not n_slots:
        return None
    return torch.empty(n_slots, _part_stride(F), dtype=torch.float32,
                       device=device)


def csr_fold(part, cut_row, cut_ptr, prev, out):
    """The second pass of the CSR kernel on a plan with cut rows:
    ``out[cut_row[i]] = prev[cut_row[i]] (or 0 without prev) + part[s]``
    for each slot s of cut row i in item order, summed in float32 and
    rounded once. The kernel wrappers call it after their launch; it
    launches ``csr_fold_kernel`` (counted in ``csr_fold.launches``)."""
    F = out.shape[1]
    fn, err = _fold_kernel(), _kernel()[1]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    with torch.cuda.device(out.device):
        code = fn(part.data_ptr(), part.shape[1], cut_row.data_ptr(),
                  cut_ptr.data_ptr(), cut_row.shape[0], _ptr(prev),
                  out.data_ptr(), F, int(out.dtype == torch.bfloat16), stream)
    _raise_on(code, "csr_fold", err)
    csr_fold.launches += 1
    return out


csr_fold.launches = 0


@torch.library.custom_op("gammagl::spmm_csr", mutates_args=())
def _spmm_csr_op(x: torch.Tensor, w: Optional[torch.Tensor],
                 rowptr: torch.Tensor, col: torch.Tensor,
                 item_ptr: Optional[torch.Tensor],
                 item_meta: Optional[torch.Tensor],
                 cut_row: Optional[torch.Tensor],
                 cut_ptr: Optional[torch.Tensor], n_slots: int,
                 per_edge: int) -> torch.Tensor:
    """``out[d] = sum_e w_e * x[r(e)]`` over the CSR edges of row d, with
    r(e) = col[e], or e when ``per_edge``: the forward of `spmm_csr` and
    `segment_sum_csr` on a plan's arrays (`_op_args`). CPU: the plain
    version; CUDA: the kernel (and `csr_fold`), counted as the wrappers
    count it."""
    raise ValueError(f"gammagl::spmm_csr: no kernel for device {x.device}")


@_spmm_csr_op.register_kernel("cpu")
def _spmm_csr_cpu(x, w, rowptr, col, item_ptr, item_meta, cut_row, cut_ptr,
                  n_slots, per_edge):
    return _csr_sum_arrays(x, w, rowptr, col, bool(per_edge))


@_spmm_csr_op.register_kernel("cuda")
def _spmm_csr_cuda(x, w, rowptr, col, item_ptr, item_meta, cut_row,
                   cut_ptr, n_slots, per_edge):
    return _launch_arrays(x, w, rowptr, col, item_ptr, item_meta, cut_row,
                          cut_ptr, n_slots, per_edge=bool(per_edge))


@_spmm_csr_op.register_fake
def _spmm_csr_fake(x, w, rowptr, col, item_ptr, item_meta, cut_row, cut_ptr,
                   n_slots, per_edge):
    return x.new_empty(rowptr.shape[0] - 1, x.shape[1])


def _op_args(plan, device):
    """The plan's arguments of the CSR ops on ``device``: rowptr, col, the
    work items at `ROW_SPLIT` (None for a plan without cut rows, whose
    items are its rows) and the scratch slots."""
    rowptr, col, _ = plan.arrays(device)
    item_ptr, meta, cut_row, cut_ptr, n_slots = plan.split_arrays(device)
    if meta is None:
        item_ptr = None
    return rowptr, col, item_ptr, meta, cut_row, cut_ptr, n_slots


class PlanArrays:
    """A `CSRPlan` as an op's implementation sees it: the arrays it was
    handed (`_op_args`), read through the plan's own interface
    (`arrays`, `split_arrays`, ``num_nodes``, ``num_edges``), so the plain
    versions and the launches written for a plan run on them unchanged.
    It holds the items of one size, whatever K it is asked for; the
    wrappers check ``num_src`` before the op, so it has none."""

    def __init__(self, rowptr, col, perm=None, item_ptr=None,
                 item_meta=None, cut_row=None, cut_ptr=None, n_slots=0):
        self.num_nodes = rowptr.shape[0] - 1
        self.num_edges = col.shape[0]
        self._arrays = (rowptr, col, perm)
        if item_meta is None:
            self._split = (rowptr, None, None, None, 0)
        else:
            self._split = (item_ptr, item_meta, cut_row, cut_ptr,
                           int(n_slots))

    def arrays(self, device=None):
        return self._arrays

    def split_arrays(self, device=None, K=None):
        return self._split


def _forward(x, w, plan, per_edge=False):
    return torch.ops.gammagl.spmm_csr(x, w, *_op_args(plan, x.device),
                                      int(per_edge))


def _check_prev(prev, x, plan):
    if prev is None:
        return
    if (prev.shape != (plan.num_nodes, x.shape[1]) or prev.dtype != x.dtype
            or prev.device != x.device):
        raise ValueError(
            f"prev must be ({plan.num_nodes}, {x.shape[1]}) {x.dtype} on "
            f"{x.device}, got {tuple(prev.shape)} {prev.dtype} on "
            f"{prev.device}")
    if not prev.is_contiguous():
        raise ValueError("prev must be contiguous")


def _pad_rows(d, n_rows):
    """d with zero rows appended up to ``n_rows`` (rows no edge reads)."""
    if d.shape[0] >= n_rows:
        return d
    return torch.cat([d, d.new_zeros((n_rows - d.shape[0],) + d.shape[1:])])


def _first_order_only(op):
    """Raise in a backward taken with ``create_graph=True``: the kernels
    have no backward of their own, so the gradient they return would be
    taken as a constant and a second derivative silently dropped."""
    if torch.is_grad_enabled():
        raise RuntimeError(f"{op} is differentiable once; a backward with "
                           "create_graph=True is not supported")


class _SpmmCSR(torch.autograd.Function):
    """x, w (CSR order) -> out, with dx = A^T (w * g) on the transpose plan
    (one more SpMM: a kernel launch on the card) and dw_e = <x[src_e],
    g[dst_e]> (the SDDMM kernel), taken only when w needs a gradient."""

    @staticmethod
    def forward(ctx, x, w, plan):
        ctx.save_for_backward(x, w)
        ctx.plan = plan
        return _forward(x, w, plan)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("spmm_csr")
        x, w = ctx.saved_tensors
        plan = ctx.plan
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            tp = plan.transpose()
            w_t = None
            if w is not None:
                w_t = w[tp.arrays(w.device)[2]]
            dx = _pad_rows(_forward(g, w_t, tp), x.shape[0])
        if w is not None and ctx.needs_input_grad[1]:
            from gammagl_tpu_torch.ops.cuda.sddmm_csr import _sddmm
            dw = _sddmm(x, g, plan, 1, gather=True)[:, 0]
        return dx, dw, None


def spmm_csr(x, edge_weight, plan, weights_padded=False):
    """out[d] = sum_{(s,d)} w_sd * x[s] over the plan's edges.

    x : (N_src, F) float32 or bfloat16; the result has x's dtype, summed
        in float32 and rounded once.
    edge_weight : (E,) in the caller's edge order, None for unit weights,
        or the output of `pad_edge_weights` with ``weights_padded=True``.

    A CPU tensor takes `spmm_csr_reference`. A CUDA tensor launches the
    kernel (and `csr_fold` after it when the plan has cut rows) or raises;
    it never falls back. Differentiable once in ``x``
    and ``edge_weight`` (``create_graph=True`` raises on every device); the
    backward of ``x`` is another launch of the kernel on the card
    (counted in ``spmm_csr.launches`` too).
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spmm_csr: no kernel for device {x.device}")
    _check_x(x, plan)
    w = _csr_weights(edge_weight, plan, weights_padded)
    return _SpmmCSR.apply(x, w, plan)


spmm_csr.launches = 0


def spmm_csr_acc(x, edge_weight, plan, prev=None, weights_padded=False,
                 out=None):
    """out = prev + A x: `spmm_csr` added to a previous partial sum.

    x : (N_src, F) float32 or bfloat16, contiguous; it may be a row slice
        of a larger table (``table[lo:hi]``).
    edge_weight : (E,) as for `spmm_csr`, or None for unit weights.
    prev : (plan.num_nodes, F) of x's dtype, contiguous, or None, which
        makes this `spmm_csr` (its kernel, counted in
        ``spmm_csr.launches``).
    out : where to write, None for a new tensor; it may be ``prev``
        itself (in place).

    The edges are added to prev in float32, in CSR order, and the sum is
    rounded once to x's dtype, so a row without edges keeps prev bit for
    bit. The op ``gammagl::spmm_csr_acc`` (with ``out``,
    ``gammagl::spmm_csr_acc_out``): a CPU tensor takes the plain version,
    a CUDA tensor launches the kernel (counted in
    ``spmm_csr_acc.launches``) or raises.
    Not differentiable, like the TPU kernel it replaces: a call autograd
    would have to record raises (the planned halo tier takes its backward
    from the transpose partition).
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spmm_csr_acc: no kernel for device {x.device}")
    _check_x(x, plan)
    _check_prev(prev, x, plan)
    if out is not None and (out.shape != (plan.num_nodes, x.shape[1])
                            or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({plan.num_nodes}, "
                         f"{x.shape[1]}) {x.dtype} tensor on {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, edge_weight, prev)):
        raise RuntimeError("spmm_csr_acc is not differentiable; call it "
                           "under torch.no_grad(), or take spmm_csr")
    w = _csr_weights(edge_weight, plan, weights_padded)
    args = _op_args(plan, x.device)
    if out is None:
        return torch.ops.gammagl.spmm_csr_acc(x, w, prev, *args)
    torch.ops.gammagl.spmm_csr_acc_out(x, w, prev, out, *args)
    return out


spmm_csr_acc.launches = 0


@torch.library.custom_op("gammagl::spmm_csr_acc", mutates_args=())
def _spmm_csr_acc_op(x: torch.Tensor, w: Optional[torch.Tensor],
                     prev: Optional[torch.Tensor], rowptr: torch.Tensor,
                     col: torch.Tensor, item_ptr: Optional[torch.Tensor],
                     item_meta: Optional[torch.Tensor],
                     cut_row: Optional[torch.Tensor],
                     cut_ptr: Optional[torch.Tensor],
                     n_slots: int) -> torch.Tensor:
    """``prev + A x`` (prev None: ``A x``) on a plan's arrays: the forward
    of `spmm_csr_acc`. CPU: the plain version; CUDA: the kernel with its
    accumulating flag (and `csr_fold`), counted as `spmm_csr_acc` counts
    it."""
    raise ValueError(f"gammagl::spmm_csr_acc: no kernel for device "
                     f"{x.device}")


@_spmm_csr_acc_op.register_kernel("cpu")
def _spmm_csr_acc_cpu(x, w, prev, rowptr, col, item_ptr, item_meta,
                      cut_row, cut_ptr, n_slots):
    return _csr_sum_arrays(x, w, rowptr, col, False, prev)


@_spmm_csr_acc_op.register_kernel("cuda")
def _spmm_csr_acc_cuda(x, w, prev, rowptr, col, item_ptr, item_meta,
                       cut_row, cut_ptr, n_slots):
    return _launch_arrays(x, w, rowptr, col, item_ptr, item_meta, cut_row,
                          cut_ptr, n_slots, prev=prev)


@_spmm_csr_acc_op.register_fake
def _spmm_csr_acc_fake(x, w, prev, rowptr, col, item_ptr, item_meta,
                       cut_row, cut_ptr, n_slots):
    return x.new_empty(rowptr.shape[0] - 1, x.shape[1])


@torch.library.custom_op("gammagl::spmm_csr_acc_out", mutates_args=("out",))
def _spmm_csr_acc_out_op(x: torch.Tensor, w: Optional[torch.Tensor],
                         prev: Optional[torch.Tensor], out: torch.Tensor,
                         rowptr: torch.Tensor, col: torch.Tensor,
                         item_ptr: Optional[torch.Tensor],
                         item_meta: Optional[torch.Tensor],
                         cut_row: Optional[torch.Tensor],
                         cut_ptr: Optional[torch.Tensor],
                         n_slots: int) -> None:
    """``gammagl::spmm_csr_acc`` written into ``out``, which may be
    ``prev`` itself (the planned halo tier folds each class in place)."""
    raise ValueError(f"gammagl::spmm_csr_acc_out: no kernel for device "
                     f"{x.device}")


@_spmm_csr_acc_out_op.register_kernel("cpu")
def _spmm_csr_acc_out_cpu(x, w, prev, out, rowptr, col, item_ptr, item_meta,
                          cut_row, cut_ptr, n_slots):
    out.copy_(_csr_sum_arrays(x, w, rowptr, col, False, prev))


@_spmm_csr_acc_out_op.register_kernel("cuda")
def _spmm_csr_acc_out_cuda(x, w, prev, out, rowptr, col, item_ptr,
                           item_meta, cut_row, cut_ptr, n_slots):
    _launch_arrays(x, w, rowptr, col, item_ptr, item_meta, cut_row, cut_ptr,
                   n_slots, prev=prev, out=out)


@_spmm_csr_acc_out_op.register_fake
def _spmm_csr_acc_out_fake(x, w, prev, out, rowptr, col, item_ptr,
                           item_meta, cut_row, cut_ptr, n_slots):
    return None


class _SegmentSum(torch.autograd.Function):
    """v (E, C) per-edge rows, w (E,) or (E, H) or None -> (N_dst, C).
    dv = the expand kernel scaled by w; dw = the per-edge SDDMM kernel
    <v[e], g[row(e)]> per head (`ops.cuda.sddmm_csr`)."""

    @staticmethod
    def forward(ctx, v, w, plan):
        ctx.save_for_backward(v, w)
        ctx.plan = plan
        return _forward(v, w, plan, per_edge=True)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("segment_sum_csr")
        from gammagl_tpu_torch.ops.cuda.sddmm_csr import _expand, _sddmm
        v, w = ctx.saved_tensors
        plan = ctx.plan
        g = g.to(v.dtype).contiguous()
        dv = dw = None
        if ctx.needs_input_grad[0]:
            scale = w if w is None or w.dim() == 2 else w[:, None]
            dv = _expand(g, plan, scale)
        if w is not None and ctx.needs_input_grad[1]:
            heads = 1 if w.dim() == 1 else w.shape[1]
            dw = _sddmm(v, g, plan, heads, gather=False).view(w.shape)
        return dv, dw, None


def segment_sum_csr(v, plan, w=None):
    """out[d] = sum_{e of row d} w_e * v[e]: per-edge rows in the plan's CSR
    order summed into their destination rows.

    v : (E, C) float32 or bfloat16; the result (N_dst, C) has v's dtype,
        summed in float32 and rounded once.
    w : None (unit weights), (E,), or (E, H) with C % H == 0, where
        ``w[e, h]`` scales the columns ``c // (C / H) == h``; CSR order.

    Counterpart of the JAX package's `segment_sum_csr` and of
    `segment_sum_win`: a CSR has no window layout, so the padded and the
    compact orders are both this CSR order. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (counted in
    ``segment_sum_csr.launches``) or raises. Differentiable once in v and
    w.
    """
    if v.dim() != 2 or v.shape[0] != plan.num_edges:
        raise ValueError(f"v must be (E={plan.num_edges}, C), got "
                         f"{tuple(v.shape)}")
    if v.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_sum_csr: no kernel for device {v.device}")
    if w is not None:
        if w.dim() not in (1, 2) or w.shape[0] != plan.num_edges or (
                w.dim() == 2 and v.shape[1] % w.shape[1]):
            raise ValueError(f"w shape {tuple(w.shape)} is not (E,) or "
                             f"(E, H) with H dividing {v.shape[1]}")
        w = w.float()
    return _SegmentSum.apply(v, w, plan)


segment_sum_csr.launches = 0


class _GatherSrc(torch.autograd.Function):
    """x (N_src, C) -> x[col] (E, C) in CSR order. The forward is plain
    indexing (the JAX package gathers in XLA, outside any kernel); the
    backward sums the per-edge cotangents into their sources with
    `spmm_csr` on the plan's edge-scatter transpose, a kernel launch on
    the card."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.n_rows = plan, x.shape[0]
        return x.index_select(0, plan.arrays(x.device)[1])

    @staticmethod
    def backward(ctx, g):
        _first_order_only("gather_rows")
        d = _forward(g.contiguous(), None, ctx.plan.edge_scatter_plan())
        return _pad_rows(d, ctx.n_rows), None


def gather_rows(x, plan, index_kind="src"):
    """Per-edge endpoint rows in the plan's CSR order: ``x[src_e]``
    (``"src"``) or ``x[dst_e]`` (``"dst"``, which is `expand_dst_csr`).

    x : (N, ...) -> (E, ...). Differentiable once; the backward of
    ``"src"`` is `spmm_csr` on `CSRPlan.edge_scatter_plan`, that of
    ``"dst"`` `segment_sum_csr`.
    """
    if index_kind == "dst":
        from gammagl_tpu_torch.ops.cuda.sddmm_csr import expand_dst_csr
        return expand_dst_csr(x, plan)
    if index_kind != "src":
        raise ValueError(f"index_kind must be 'src' or 'dst', got "
                         f"{index_kind!r}")
    if x.shape[0] < plan.num_src:
        raise ValueError(f"x has {x.shape[0]} rows, the plan reads "
                         f"{plan.num_src}")
    out = _GatherSrc.apply(x.flatten(1), plan)
    return out.view((plan.num_edges,) + tuple(x.shape[1:]))
