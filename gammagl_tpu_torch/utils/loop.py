"""Self-loop insertion and removal (counterpart of
`gammagl_tpu/utils/loop.py`). Eager helpers for graph preprocessing:
removal gives a data-dependent number of edges."""

import numpy as np
import torch

__all__ = ["add_self_loops", "remove_self_loops", "contains_self_loops"]


def add_self_loops(edge_index, edge_attr=None, fill_value=1.0,
                   num_nodes=None, n_loops=1):
    """Append (i, i) edges for every node, ``n_loops`` times over.

    Takes numpy arrays (host graphs) or torch tensors and returns the same
    kind: (edge_index, edge_attr).
    """
    if num_nodes is None:
        num_nodes = int(edge_index.max()) + 1
    n_fill = num_nodes * n_loops
    if isinstance(edge_index, torch.Tensor):
        loops = torch.arange(num_nodes, dtype=edge_index.dtype,
                             device=edge_index.device).repeat(n_loops)
        out = torch.cat([edge_index, torch.stack([loops, loops])], 1)
        if edge_attr is not None:
            fill = edge_attr.new_full((n_fill,) + tuple(edge_attr.shape[1:]),
                                      fill_value)
            edge_attr = torch.cat([edge_attr, fill], 0)
        return out, edge_attr
    loops = np.tile(np.arange(num_nodes, dtype=edge_index.dtype), n_loops)
    out = np.concatenate([edge_index, np.stack([loops, loops])], 1)
    if edge_attr is not None:
        fill = np.full((n_fill,) + tuple(edge_attr.shape[1:]), fill_value,
                       dtype=edge_attr.dtype)
        edge_attr = np.concatenate([edge_attr, fill], 0)
    return out, edge_attr


def remove_self_loops(edge_index, edge_attr=None):
    """Drop the (i, i) edges: (edge_index, edge_attr) of the others, in
    their order. Takes numpy arrays or torch tensors and returns the same
    kind."""
    mask = edge_index[0] != edge_index[1]
    if edge_attr is not None:
        edge_attr = edge_attr[mask]
    return edge_index[:, mask], edge_attr


def contains_self_loops(edge_index):
    """Whether any edge is a self-loop."""
    return bool((edge_index[0] == edge_index[1]).any())
