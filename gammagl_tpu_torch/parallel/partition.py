"""Graph partitioning, counterpart of `gammagl_tpu/parallel/partition.py`.

Only the community ordering is here so far; the edge partitions come
with the ``torch.distributed`` tiers.
"""

import numpy as np

__all__ = ["cluster_permutation"]


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
