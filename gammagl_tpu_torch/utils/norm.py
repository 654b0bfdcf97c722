"""GCN normalization weights on the host (counterpart of
`gammagl_tpu/utils/norm.py`'s `calc_gcn_norm_np`)."""

import numpy as np

__all__ = ["calc_gcn_norm_np"]


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
