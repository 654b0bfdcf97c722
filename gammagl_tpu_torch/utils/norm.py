"""GCN normalization weights (counterpart of `gammagl_tpu/utils/norm.py`):
`calc_gcn_norm` on tensors, and `calc_gcn_norm_np` on the host."""

import numpy as np
import torch

from gammagl_tpu_torch.ops.segment import segment_count

__all__ = ["calc_gcn_norm", "calc_gcn_norm_np"]


def calc_gcn_norm(edge_index, num_nodes, edge_weight=None):
    """Symmetric GCN edge weights D^-1/2 A D^-1/2 (self-loops assumed
    added), the 'both' norm of the reference GCNConv, on edge_index's
    device. The degree is the UNWEIGHTED in-degree, as in the JAX package,
    counted in float32 (the JAX package counts in the weights' dtype,
    which saturates at 256 in bf16: ROADMAP C1); the result has the
    weights' dtype (float32 without weights)."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    if edge_weight is None:
        edge_weight = torch.ones(src.shape[0], device=src.device)
    deg = segment_count(dst, num_nodes)
    dis = torch.where(deg > 0, deg.pow(-0.5), 0.0)
    return (dis[src] * edge_weight.float() * dis[dst]).to(edge_weight.dtype)


def calc_gcn_norm_np(edge_index, num_nodes, edge_weight=None):
    """Symmetric GCN edge weights D^-1/2 A D^-1/2 in numpy, for graphs
    whose edge list should not land on a device whole before it is
    partitioned (self-loops assumed added). The degree is the UNWEIGHTED
    in-degree, as in the JAX package; float32, bit for bit the JAX
    package's result."""
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    if edge_weight is None:
        edge_weight = np.ones(src.shape[0], np.float32)
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float32)
    dis = np.zeros_like(deg)
    nz = deg > 0
    dis[nz] = deg[nz] ** -0.5
    return (dis[src] * np.asarray(edge_weight, np.float32)
            * dis[dst]).astype(np.float32)
