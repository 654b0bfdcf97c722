"""Graph partitioning, counterpart of `gammagl_tpu/parallel/partition.py`:
the community ordering of the block-pair route and the degree-balanced
node relabeling of the halo partitions (host numpy, bit for bit the JAX
package's).
"""

import numpy as np

__all__ = ["cluster_permutation", "balance_permutation"]


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
