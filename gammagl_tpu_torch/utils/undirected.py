"""Undirected-graph helpers (counterpart of
`gammagl_tpu/utils/undirected.py`), host numpy."""

import numpy as np

from gammagl_tpu_torch.utils.coalesce import coalesce

__all__ = ["to_undirected", "is_undirected"]


def to_undirected(edge_index, edge_attr=None, num_nodes=None, reduce="sum"):
    """Add every edge's reverse and coalesce."""
    ei = np.asarray(edge_index)
    full = np.concatenate([ei, ei[::-1]], axis=1)
    if edge_attr is not None:
        edge_attr = np.concatenate([np.asarray(edge_attr)] * 2, axis=0)
    return coalesce(full, edge_attr, num_nodes=num_nodes, reduce=reduce)


def is_undirected(edge_index, num_nodes=None):
    """Whether every edge's reverse is an edge too."""
    ei = np.asarray(edge_index)
    fwd = set(zip(ei[0].tolist(), ei[1].tolist()))
    return all((d, s) in fwd for s, d in fwd)
