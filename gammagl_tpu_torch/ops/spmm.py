"""SpMM over COO edges: the plan-free path of `MessagePassing`.

PyTorch counterpart of `gammagl_tpu/ops/spmm.py`: gather the source rows,
scale them by the edge weights and reduce them into their destinations.
A caller with a `Graph.csr_plan()` takes `ops.cuda.spmm_csr` instead,
which runs a hand-written kernel on the card.
"""

from typing import Optional

import torch

from gammagl_tpu_torch.ops.segment import (segment_max, segment_mean,
                                           segment_min, segment_sum)

__all__ = ["spmm", "bspmm", "gspmm"]

_REDUCE = {"sum": segment_sum, "mean": segment_mean, "max": segment_max,
           "min": segment_min}


def spmm(edge_index, edge_weight, x, num_nodes: Optional[int] = None,
         reduce: str = "sum"):
    """out[d] = reduce_{(s,d) in E} w_{sd} * x[s].

    Parameters
    ----------
    edge_index : (2, E) integer tensor, row 0 = src, row 1 = dst
    edge_weight : (E,) tensor or None
    x : (N, F) node features
    num_nodes : number of destination rows; defaults to x.shape[0]
    reduce : 'sum' | 'mean' | 'max' | 'min'

    The message has the dtype the JAX package forms it in: ``x``'s, or
    with weights ``torch.promote_types(x.dtype, edge_weight.dtype)`` (bf16
    x with f32 weights gives float32, integer x with float weights
    float32). Floating messages are formed and reduced in float32 (or
    wider) and the result is cast once to that dtype; integer sums, maxima
    and minima stay integer, and an integer mean is float32. Out-of-range
    destinations are dropped.
    """
    if reduce not in _REDUCE:
        raise ValueError(f"unknown reduce {reduce!r}")
    if num_nodes is None:
        num_nodes = x.shape[0]
    dtype = (x.dtype if edge_weight is None
             else torch.promote_types(x.dtype, edge_weight.dtype))
    src, dst = edge_index[0].long(), edge_index[1]
    # clamp the gather so an out-of-range pad src reads a real row; its
    # out-of-range dst then drops the message
    msg = x[src.clamp(0, x.shape[0] - 1)]
    msg = msg.to(torch.promote_types(dtype, torch.float32)
                 if dtype.is_floating_point else dtype)
    if edge_weight is not None:
        w = edge_weight.to(msg.dtype)
        msg = msg * w.reshape(w.shape + (1,) * (x.dim() - w.dim()))
    out = _REDUCE[reduce](msg, dst, num_nodes)
    return out.to(dtype) if dtype.is_floating_point else out


def gspmm(edge_index, edge_weight, x, reduce: str = "sum",
          num_nodes: Optional[int] = None):
    """Reference spelling of `spmm` (argument order of the reference)."""
    return spmm(edge_index, edge_weight, x, num_nodes=num_nodes,
                reduce=reduce)


def bspmm(edge_index, edge_weight, x, num_nodes: Optional[int] = None,
          reduce: str = "sum"):
    """Multi-head SpMM for attention layers: x (N, H, F), edge_weight
    (E, H) per-head coefficients, out[d, h] = reduce_e w_eh * x[s_e, h].
    Sums in float32, cast once to the message's dtype, as `spmm`."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if edge_weight is not None:
        edge_weight = edge_weight[..., None]
    return spmm(edge_index, edge_weight, x, num_nodes=num_nodes,
                reduce=reduce)
