"""Destination-sorted CSR SpMM: the plan and the kernel's wrapper.

PyTorch counterpart of `gammagl_tpu/ops/pallas/segment_matmul.py`. The
TPU module tiles a padded, source-blocked layout for its matrix unit and
gather engine. On the card one CSR serves every width and dtype: edges
sorted stably by destination, ``rowptr`` over destination rows, ``col``
the source of each CSR edge, and ``perm`` the position of each CSR edge
in the caller's edge order, so per-edge weights can follow.

`spmm_csr` computes ``out[d] = sum_{(s, d)} w_sd * x[s]``. On a CUDA
tensor it launches the hand-written kernel of ``csrc/spmm_csr.cu`` and
counts the launch in ``spmm_csr.launches``; on a CPU tensor it runs the
plain version, `spmm_csr_reference`.
"""

import ctypes
import functools

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda._build import load_library

__all__ = ["CSRPlan", "build_csr_plan", "build_csr_plan_blocked",
           "pad_edge_weights", "spmm_csr", "spmm_csr_reference"]


class CSRPlan:
    """Destination-sorted CSR of a graph, built once on the host.

    rowptr : (num_nodes + 1,) int64, edges of row d are
             [rowptr[d], rowptr[d + 1])
    col    : (num_edges,) int32, source of each CSR edge
    perm   : (num_edges,) int64, caller's index of each CSR edge

    One copy of the arrays is kept per device (`arrays`).
    """

    def __init__(self, rowptr, col, perm, num_nodes, num_src, num_edges):
        self.rowptr = rowptr
        self.col = col
        self.perm = perm
        self.num_nodes = int(num_nodes)
        self.num_src = int(num_src)
        self.num_edges = int(num_edges)
        self._placed = {}

    def arrays(self, device):
        """(rowptr, col, perm) as tensors on ``device``, copied once."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        placed = self._placed.get(device)
        if placed is None:
            # ordinary tensors even when first placed under inference
            # mode, so later autograd code may use the cached copy
            with torch.inference_mode(False):
                placed = self._placed[device] = tuple(
                    torch.from_numpy(a).to(device)
                    for a in (self.rowptr, self.col, self.perm))
        return placed

    def __repr__(self):
        return (f"CSRPlan(N={self.num_nodes}, N_src={self.num_src}, "
                f"E={self.num_edges})")


def build_csr_plan(src, dst, num_nodes, num_src=None, R=None, ET=None,
                   window=None):
    """Build the plan from COO edges on the host, in numpy.

    ``src``/``dst`` need not be sorted. Out-of-range endpoints raise.
    ``R``, ``ET`` and ``window`` are the TPU tiling keywords of the JAX
    package; a CSR needs none of them, so they are accepted and ignored.
    """
    del R, ET, window
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
                   num_nodes, num_src, E)


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


def spmm_csr_reference(x, edge_weight, plan, weights_padded=False):
    """Plain PyTorch version of `spmm_csr`: ``index_add_`` of the weighted
    source rows in float32, cast once to ``x``'s dtype."""
    _check_x(x, plan)
    rowptr, col, _ = plan.arrays(x.device)
    w = _csr_weights(edge_weight, plan, weights_padded)
    acc = torch.promote_types(x.dtype, torch.float32)
    dst = torch.repeat_interleave(
        torch.arange(plan.num_nodes, device=x.device), rowptr.diff(),
        output_size=plan.num_edges)
    msg = x[col.long()].to(acc)
    if w is not None:
        msg = msg * w.to(acc)[:, None]
    out = torch.zeros(plan.num_nodes, x.shape[1], dtype=acc, device=x.device)
    return out.index_add_(0, dst, msg).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = load_library()
    fn = lib.gammagl_spmm_csr
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.gammagl_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def spmm_csr(x, edge_weight, plan, weights_padded=False):
    """out[d] = sum_{(s,d)} w_sd * x[s] over the plan's edges.

    x : (N_src, F) float32 or bfloat16; the result has x's dtype, summed
        in float32 and rounded once.
    edge_weight : (E,) in the caller's edge order, None for unit weights,
        or the output of `pad_edge_weights` with ``weights_padded=True``.

    A CPU tensor takes `spmm_csr_reference`. A CUDA tensor launches the
    kernel or raises; it never falls back.
    """
    if x.device.type == "cpu":
        return spmm_csr_reference(x, edge_weight, plan, weights_padded)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr: no kernel for device {x.device}")
    _check_x(x, plan)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"spmm_csr: x dtype {x.dtype} is not one of "
                        f"{_KERNEL_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("spmm_csr: x must be contiguous")
    rowptr, col, _ = plan.arrays(x.device)
    w = _csr_weights(edge_weight, plan, weights_padded)
    if w is not None:
        if w.device != x.device:
            raise ValueError(f"edge weights on {w.device}, x on {x.device}")
        w = w.contiguous()
    out = torch.empty(plan.num_nodes, x.shape[1], dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    fn, err = _kernel()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), 0 if w is None else w.data_ptr(),
                  rowptr.data_ptr(), col.data_ptr(), out.data_ptr(),
                  plan.num_nodes, x.shape[1], int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream(x.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed: "
                           f"{err(code).decode()} ({code})")
    spmm_csr.launches += 1
    return out


spmm_csr.launches = 0
