"""Graph partitioning, counterpart of `gammagl_tpu/parallel/partition.py`:
the edge partitions of the sharded SpMM (`parallel/spmm.py`), the
community ordering of the block-pair route and the degree-balanced node
relabeling of the halo partitions (host numpy, bit for bit the JAX
package's).

Edge partitions:
  * `partition_edges_by_dst`: part p owns the edges whose destination
    falls in its row block of ceil(N / P) rows, so the parts' partial sums
    cover disjoint rows;
  * `partition_edges_uniform`: P runs of about E / P edges in the given
    order, whatever their destinations; the partial sums overlap and are
    summed over the group.
"""

from typing import NamedTuple

import numpy as np

__all__ = ["EdgePartition", "partition_edges_by_dst",
           "partition_edges_uniform", "cluster_permutation",
           "balance_permutation"]


class EdgePartition(NamedTuple):
    """Padded edge shards of P parts, stacked: shard p is
    ``edge_index[p]`` with ``edge_weight[p]``. Every shard is padded to
    one length, a multiple of 128, with edges ``src = dst = num_nodes``
    and weight 0, which the sharded SpMM drops."""

    edge_index: np.ndarray   # (P, 2, E_shard) int32, padded with num_nodes
    edge_weight: np.ndarray  # (P, E_shard) float32, 0 at pads (1 if none)
    row_start: np.ndarray    # (P,) first destination row owned (by dst)
    num_parts: int
    num_nodes: int


def _pad_shards(shards, wshards, num_nodes, num_parts):
    e_max = max(s.shape[1] for s in shards)
    e_max = -(-e_max // 128) * 128  # the JAX package's shard length
    ei = np.full((num_parts, 2, e_max), num_nodes, dtype=np.int32)
    w = np.zeros((num_parts, e_max), dtype=np.float32)
    for p, s in enumerate(shards):
        ei[p, :, :s.shape[1]] = s
        if wshards[p] is not None:
            w[p, :s.shape[1]] = wshards[p]
        else:
            w[p, :s.shape[1]] = 1.0
    return ei, w


def partition_edges_by_dst(edge_index, num_nodes, num_parts,
                           edge_weight=None):
    """Edge cut by destination row blocks of ceil(N / P) rows (the last
    part also takes any destination past the blocks)."""
    ei = np.asarray(edge_index)
    w = None if edge_weight is None else np.asarray(edge_weight)
    rows_per = -(-num_nodes // num_parts)
    owner = np.minimum(ei[1] // rows_per, num_parts - 1)
    shards, wshards, starts = [], [], []
    for p in range(num_parts):
        mask = owner == p
        shards.append(ei[:, mask])
        wshards.append(None if w is None else w[mask])
        starts.append(p * rows_per)
    ei_p, w_p = _pad_shards(shards, wshards, num_nodes, num_parts)
    return EdgePartition(ei_p, w_p, np.asarray(starts, np.int32),
                         num_parts, num_nodes)


def partition_edges_uniform(edge_index, num_nodes, num_parts,
                            edge_weight=None):
    """P shards of about E / P edges each, in the given edge order
    (``linspace`` bounds); their destinations are arbitrary, so the
    partial sums are summed over the group."""
    ei = np.asarray(edge_index)
    w = None if edge_weight is None else np.asarray(edge_weight)
    E = ei.shape[1]
    bounds = np.linspace(0, E, num_parts + 1).astype(np.int64)
    shards, wshards = [], []
    for p in range(num_parts):
        sl = slice(bounds[p], bounds[p + 1])
        shards.append(ei[:, sl])
        wshards.append(None if w is None else w[sl])
    ei_p, w_p = _pad_shards(shards, wshards, num_nodes, num_parts)
    return EdgePartition(ei_p, w_p, np.zeros(num_parts, np.int32),
                         num_parts, num_nodes)


def cluster_permutation(edge_index, num_nodes, rounds=8):
    """Community-clustering node relabeling by vectorized label
    propagation (numpy): each round every node adopts the most common
    label among its undirected neighbours (ties to the smaller label),
    for at most ``rounds`` rounds; nodes are then laid out
    cluster-contiguously, which makes the (dst block, src block) tiling
    of the block-pair SpMM dense on clustered graphs.

    Returns (perm, inv): relabel edges with ``inv[edge_index]``, node rows
    with ``x[perm]`` (the `reorder_bandwidth` contract).
    """
    ei = np.asarray(edge_index)
    und_src = np.concatenate([ei[0], ei[1]]).astype(np.int64)
    und_dst = np.concatenate([ei[1], ei[0]]).astype(np.int64)
    labels = np.arange(num_nodes, dtype=np.int64)
    for _ in range(rounds):
        nl = labels[und_src]
        order = np.lexsort((nl, und_dst))
        d_s, l_s = und_dst[order], nl[order]
        change = np.nonzero((d_s[1:] != d_s[:-1])
                            | (l_s[1:] != l_s[:-1]))[0] + 1
        starts = np.concatenate([[0], change, [len(d_s)]])
        run_node = d_s[starts[:-1]]
        run_label = l_s[starts[:-1]]
        run_count = np.diff(starts)
        # per node: the label with the highest count, ties to the smaller
        o2 = np.lexsort((run_label, -run_count, run_node))
        first = np.concatenate([[True],
                                run_node[o2][1:] != run_node[o2][:-1]])
        new = labels.copy()
        new[run_node[o2][first]] = run_label[o2][first]
        if np.array_equal(new, labels):
            break
        labels = new
    perm = np.lexsort((np.arange(num_nodes), labels)).astype(np.int64)
    inv = np.empty(num_nodes, np.int64)
    inv[perm] = np.arange(num_nodes)
    return perm, inv


def balance_permutation(edge_index, num_nodes, num_parts, row_align=8):
    """Degree-balanced node relabeling for the block-owner halo partitions.

    The halo tiers give node v to part ``v // rows_per``; on power-law
    graphs a natural order piles high in-degree nodes into a few blocks.
    This deals nodes to the P owner blocks greedily by in-degree (largest
    first, into the lightest block that is not full), so every block owns
    about as many edges.

    Returns ``(perm, inv)`` with the `reorder_bandwidth` contract:
    relabel edges with ``inv[edge_index]``, node rows with ``x[perm]``.
    Parts 0..P-2 get exactly ``rows_per`` nodes, the last the rest; the
    identity when the graph is too small to fill P-1 aligned blocks.
    """
    ei = np.asarray(edge_index)
    ceil_rows = -(-num_nodes // num_parts)
    rows_per = -(-ceil_rows // row_align) * row_align
    caps = np.full(num_parts, rows_per, np.int64)
    caps[-1] = num_nodes - (num_parts - 1) * rows_per
    if caps[-1] < 0:
        ident = np.arange(num_nodes, dtype=np.int64)
        return ident, ident
    indeg = np.bincount(ei[1], minlength=num_nodes).astype(np.int64)
    order = np.argsort(-indeg, kind="stable")
    load = np.zeros(num_parts, np.float64)
    fill = np.zeros(num_parts, np.int64)
    assign = np.empty(num_nodes, np.int64)
    for v in order:
        p = int(np.argmin(np.where(fill < caps, load, np.inf)))
        assign[v] = p
        fill[p] += 1
        load[p] += indeg[v]
    # new id = block offset + arrival order within the block
    starts = np.arange(num_parts, dtype=np.int64) * rows_per
    fill[:] = 0
    inv = np.empty(num_nodes, np.int64)
    for v in order:
        p = assign[v]
        inv[v] = starts[p] + fill[p]
        fill[p] += 1
    perm = np.empty(num_nodes, np.int64)
    perm[inv] = np.arange(num_nodes)
    return perm, inv
