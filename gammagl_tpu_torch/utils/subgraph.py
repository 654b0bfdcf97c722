"""Subgraph extraction (counterpart of `gammagl_tpu/utils/subgraph.py`;
reference: gammagl/utils/subgraph.py:6 k_hop_subgraph). Host numpy."""

import numpy as np

__all__ = ["subgraph", "k_hop_subgraph"]


def subgraph(subset, edge_index, edge_attr=None, relabel_nodes=False,
             num_nodes=None):
    """Edges whose endpoints both lie in ``subset`` (host-side).

    ``subset`` may be an index array or boolean mask.
    """
    ei = np.asarray(edge_index)
    subset = np.asarray(subset)
    if num_nodes is None:
        num_nodes = int(max(int(ei.max()) + 1 if ei.size else 0,
                            (subset.max() + 1) if subset.dtype != bool
                            else len(subset)))
    if subset.dtype == bool:
        mask = subset
    else:
        mask = np.zeros(num_nodes, dtype=bool)
        mask[subset] = True
    edge_mask = mask[ei[0]] & mask[ei[1]]
    out = ei[:, edge_mask]
    if relabel_nodes:
        relabel = np.full(num_nodes, -1, dtype=ei.dtype)
        keep = np.nonzero(mask)[0]
        relabel[keep] = np.arange(len(keep), dtype=ei.dtype)
        out = relabel[out]
    if edge_attr is not None:
        edge_attr = np.asarray(edge_attr)[edge_mask]
    return out, edge_attr, edge_mask


def k_hop_subgraph(node_idx, num_hops, edge_index, relabel_nodes=False,
                   num_nodes=None, flow="source_to_target"):
    """Nodes/edges within ``num_hops`` of ``node_idx``.

    Returns (subset, edge_index, mapping of seeds into subset, edge_mask),
    matching the reference signature.
    """
    ei = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1 if ei.size else 0
    if flow == "source_to_target":
        row, col = ei[0], ei[1]
    else:
        row, col = ei[1], ei[0]
    node_idx = np.atleast_1d(np.asarray(node_idx))
    node_mask = np.zeros(num_nodes, dtype=bool)
    subsets = [node_idx]
    cur = np.zeros(num_nodes, dtype=bool)
    cur[node_idx] = True
    for _ in range(num_hops):
        node_mask |= cur
        edge_sel = cur[col]
        new = row[edge_sel]
        cur = np.zeros(num_nodes, dtype=bool)
        cur[new] = True
        subsets.append(new)
    node_mask |= cur
    subset = np.unique(np.concatenate(subsets))
    edge_mask = node_mask[row] & node_mask[col] if False else (
        np.isin(ei[0], subset) & np.isin(ei[1], subset))
    out = ei[:, edge_mask]
    mapping = None
    if relabel_nodes:
        relabel = np.full(num_nodes, -1, dtype=ei.dtype)
        relabel[subset] = np.arange(len(subset), dtype=ei.dtype)
        out = relabel[out]
        mapping = relabel[node_idx]
    else:
        mapping = node_idx
    return subset, out, mapping, edge_mask
