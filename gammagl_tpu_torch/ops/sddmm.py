"""SDDMM over COO edges: per-edge combinations of endpoint features.

PyTorch counterpart of `gammagl_tpu/ops/sddmm.py`, in plain PyTorch. A
caller with a `Graph.csr_plan()` takes `ops.cuda.sddmm_csr` instead, which
runs a hand-written kernel on the card.
"""

import torch

__all__ = ["sddmm", "sddmm_dot"]


def _gather(x, idx):
    return x[idx.long().clamp(0, x.shape[0] - 1)]


def sddmm(edge_index, x_src, x_dst, op: str = "dot"):
    """Per-edge combination of source / destination node features.

    op='dot' : (E,[H]) contraction over the last axis (attention logits)
    op='add' / 'mul' / 'sub' : (E,[H],F) elementwise combine
    """
    a = _gather(x_src, edge_index[0])
    b = _gather(x_dst, edge_index[1])
    if op == "dot":
        return (a * b).sum(-1)
    if op == "add":
        return a + b
    if op == "mul":
        return a * b
    if op == "sub":
        return a - b
    raise ValueError(f"unknown op {op!r}")


def sddmm_dot(edge_index, x_src, x_dst):
    """Edge dot products: out[e] = <x_src[src_e], x_dst[dst_e]>."""
    return sddmm(edge_index, x_src, x_dst, op="dot")
