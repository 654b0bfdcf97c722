"""Halo partitioning, counterpart of `gammagl_tpu/parallel/halo.py`.

Only the bandwidth-reducing node ordering is here so far; the halo
exchange itself comes with the ``torch.distributed`` tiers.
"""

import numpy as np

__all__ = ["reorder_bandwidth"]


def reorder_bandwidth(edge_index, num_nodes):
    """Reverse Cuthill-McKee node reordering (scipy, ``symmetric_mode``):
    a banded adjacency after it.

    Returns (perm, inv) with new_id = inv[old_id]: relabel edges with
    ``inv[edge_index]`` and node rows with ``x[perm]``. ``perm`` is a
    contiguous copy (scipy returns a reversed view, which
    ``torch.from_numpy`` refuses).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ei = np.asarray(edge_index)
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(num_nodes, num_nodes)).tocsr()
    perm = np.ascontiguousarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_nodes)
    return perm, inv
