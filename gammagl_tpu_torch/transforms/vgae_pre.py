"""VGAE link-prediction preprocessing (counterpart of
`gammagl_tpu/transforms/vgae_pre.py`).

Reference: gammagl/transforms/vgae_pre.py (sparse_to_tuple:5,
mask_test_edges:14, sp_normalize). The reference draws negative edges one at
a time in a Python while-loop with O(E) membership scans per draw; here
negatives are drawn in vectorized batches and filtered against a hashed edge
set — same output contract (train edges + val/test pos/neg edge arrays),
orders of magnitude faster on large graphs, and deterministic under a seed.
"""

import numpy as np

__all__ = ["sparse_to_tuple", "mask_test_edges", "normalize_adj_for_vgae"]


def sparse_to_tuple(sparse_mx):
    """(coords, values, shape) triple of a scipy sparse matrix (reference
    vgae_pre.py:5-11)."""
    import scipy.sparse as sp
    if not sp.isspmatrix_coo(sparse_mx):
        sparse_mx = sparse_mx.tocoo()
    coords = np.vstack((sparse_mx.row, sparse_mx.col)).T
    return coords, sparse_mx.data, sparse_mx.shape


def _sample_negatives(num, n, forbidden, rng):
    """Vectorized rejection sampling of `num` node pairs not in
    `forbidden` (a set of i*n+j hashes) and not self-loops."""
    out = []
    taken = set()
    while len(out) < num:
        cand = rng.integers(0, n, (2, 2 * (num - len(out)) + 8))
        for i, j in cand.T:
            h = int(i) * n + int(j)
            hr = int(j) * n + int(i)
            if i == j or h in forbidden or h in taken or hr in taken:
                continue
            taken.add(h)
            out.append((int(i), int(j)))
            if len(out) == num:
                break
    return np.asarray(out, np.int64)


def mask_test_edges(edge_index, num_nodes, val_frac=0.05, test_frac=0.10,
                    seed=None):
    """Split undirected edges into train / val / test with matched negative
    samples (reference vgae_pre.py:14-90).

    Parameters
    ----------
    edge_index : (2, E) array (directed representation of an undirected
        graph; both directions may be present)
    Returns
    -------
    dict with train_edge_index (both directions), val/test
    pos and neg (K, 2) arrays.
    """
    rng = np.random.default_rng(seed)
    src, dst = np.asarray(edge_index)
    keep = src != dst                       # reference removes the diagonal
    src, dst = src[keep], dst[keep]
    upper = src < dst                       # unique undirected edges
    edges = np.unique(np.stack([src[upper], dst[upper]], 1), axis=0)

    e = edges.shape[0]
    num_val = int(np.floor(e * val_frac))
    num_test = int(np.floor(e * test_frac))
    perm = rng.permutation(e)
    val_idx = perm[:num_val]
    test_idx = perm[num_val:num_val + num_test]
    train_idx = perm[num_val + num_test:]

    val_edges = edges[val_idx]
    test_edges = edges[test_idx]
    train_edges = edges[train_idx]

    forbidden = set((int(i) * num_nodes + int(j)) for i, j in edges)
    forbidden |= set((int(j) * num_nodes + int(i)) for i, j in edges)
    val_neg = _sample_negatives(num_val, num_nodes, forbidden, rng)
    test_neg = _sample_negatives(num_test, num_nodes, forbidden, rng)

    train_ei = np.concatenate([train_edges.T, train_edges.T[::-1]], 1)
    return {
        "train_edge_index": train_ei,
        "val_edges": val_edges, "val_edges_false": val_neg,
        "test_edges": test_edges, "test_edges_false": test_neg,
    }


def normalize_adj_for_vgae(edge_index, num_nodes):
    """Symmetric GCN normalization weights with self-loops for the VGAE
    encoder (reference vgae_pre.py sp_normalize): returns
    (edge_index_with_loops, edge_weight)."""
    from gammagl_tpu_torch.utils import add_self_loops, calc_gcn_norm_np
    ei, _ = add_self_loops(np.asarray(edge_index), num_nodes=num_nodes)
    return ei, calc_gcn_norm_np(ei, num_nodes)
