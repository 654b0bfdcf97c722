"""SparseGraph and CSRAdj: host-side numpy adjacency with cached formats
(counterpart of `gammagl_tpu/sparse/sparse_graph.py`).

The conversions are computed on first use and kept; `sample_adj` is the
layered GraphSAGE sampling surface. Everything here is numpy: the results
feed plans and loaders, which copy what they need to a device.
"""

import numpy as np

from gammagl_tpu_torch.ops.sparse import ind2ptr_np

__all__ = ["SparseGraph", "CSRAdj"]


class SparseGraph:
    """COO adjacency (row, col, optional value) with cached CSR and CSC
    pointers. ``sparse_sizes`` defaults to (max row + 1, max col + 1)."""

    def __init__(self, row, col, value=None, sparse_sizes=None):
        self._row = np.asarray(row, np.int64)
        self._col = np.asarray(col, np.int64)
        self._value = None if value is None else np.asarray(value)
        if sparse_sizes is None:
            m = int(self._row.max()) + 1 if self._row.size else 0
            n = int(self._col.max()) + 1 if self._col.size else 0
            sparse_sizes = (m, n)
        self._sizes = tuple(sparse_sizes)
        self._csr = None  # (rowptr, col sorted by row, perm)
        self._csc = None  # (colptr, row sorted by col, perm)

    @classmethod
    def from_edge_index(cls, edge_index, edge_attr=None, sparse_sizes=None):
        ei = np.asarray(edge_index)
        return cls(ei[0], ei[1], edge_attr, sparse_sizes)

    def sparse_sizes(self):
        return self._sizes

    @property
    def nnz(self):
        return len(self._row)

    def coo(self):
        return self._row, self._col, self._value

    def csr(self):
        """(rowptr, col, perm): entries stably sorted by row, perm the COO
        position of each."""
        if self._csr is None:
            perm = np.argsort(self._row, kind="stable")
            rowptr = ind2ptr_np(self._row[perm], self._sizes[0])
            self._csr = (rowptr, self._col[perm], perm)
        return self._csr

    def csc(self):
        """(colptr, row, perm): entries stably sorted by column."""
        if self._csc is None:
            perm = np.argsort(self._col, kind="stable")
            colptr = ind2ptr_np(self._col[perm], self._sizes[1])
            self._csc = (colptr, self._row[perm], perm)
        return self._csc

    def t(self):
        """The transpose: rows and columns swapped, values kept."""
        return SparseGraph(self._col, self._row, self._value,
                           (self._sizes[1], self._sizes[0]))

    def sample_adj(self, subset, num_neighbors, replace=False, rng=None):
        """Sample up to ``num_neighbors`` in-neighbours (entries of each
        node's column) of every node of ``subset``; a negative count takes
        them all.

        Returns (block, n_id): ``n_id`` starts with ``subset`` and appends
        each newly seen source in the order met; ``block`` is a bipartite
        `SparseGraph` with row = the source's position in n_id, col = the
        destination's position in subset, value = the COO position of the
        sampled entry, sizes (len(n_id), len(subset)). ``rng`` is a numpy
        Generator (None: a fresh one).
        """
        rng = rng or np.random.default_rng()
        colptr, row_sorted, perm = self.csc()
        subset = np.asarray(subset, np.int64)
        local = {int(n): i for i, n in enumerate(subset)}
        n_id = list(subset)
        rows, cols, eids = [], [], []
        for i, dst in enumerate(subset):
            lo, hi = colptr[dst], colptr[dst + 1]
            deg = hi - lo
            if deg == 0:
                continue
            if num_neighbors < 0 or deg <= num_neighbors:
                take = np.arange(lo, hi)
            elif replace:
                take = lo + rng.integers(0, deg, num_neighbors)
            else:
                take = lo + rng.choice(deg, num_neighbors, replace=False)
            for e in take:
                s = int(row_sorted[e])
                if s not in local:
                    local[s] = len(n_id)
                    n_id.append(s)
                rows.append(local[s])
                cols.append(i)
                eids.append(int(perm[e]))
        block = SparseGraph(np.asarray(rows, np.int64),
                            np.asarray(cols, np.int64),
                            np.asarray(eids, np.int64),
                            (len(n_id), len(subset)))
        return block, np.asarray(n_id, np.int64)


class CSRAdj:
    """CSR adjacency by source: ``rowptr`` (num_nodes + 1,), ``col`` the
    destination of each edge, edges stably sorted by source."""

    def __init__(self, rowptr, col, num_nodes):
        self.rowptr = np.asarray(rowptr, np.int64)
        self.col = np.asarray(col, np.int64)
        self.num_nodes = num_nodes

    @classmethod
    def from_edges(cls, src, dst, num_nodes=None):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if num_nodes is None:
            num_nodes = int(max(src.max(), dst.max())) + 1
        perm = np.argsort(src, kind="stable")
        rowptr = ind2ptr_np(src[perm], num_nodes)
        return cls(rowptr, dst[perm], num_nodes)

    def degree(self):
        """Out-degree of every node."""
        return np.diff(self.rowptr)
