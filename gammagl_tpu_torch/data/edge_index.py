"""EdgeIndex: a COO edge array with cached CSR / CSC views (counterpart
of `gammagl_tpu/data/edge_index.py`; reference gammagl/data/EdgeIndex.py:15).
Host numpy, for loaders and stores."""

import numpy as np

from gammagl_tpu_torch.data.graph import _host
from gammagl_tpu_torch.ops.sparse import ind2ptr_np

__all__ = ["EdgeIndex"]


class EdgeIndex:
    """(2, E) int64 edges of a (rows, cols) ``sparse_size`` (default: one
    past the largest id, both ways), sorted by ``sort_order`` (None,
    'row' or 'col') when the caller says so."""

    def __init__(self, edge_index, sparse_size=None, sort_order=None):
        self.data = np.asarray(_host(edge_index), np.int64)
        if sparse_size is None:
            m = int(self.data.max()) + 1 if self.data.size else 0
            sparse_size = (m, m)
        self.sparse_size = tuple(sparse_size)
        self.sort_order = sort_order
        self._rowptr = None
        self._colptr = None
        self._perm_row = None
        self._perm_col = None

    @property
    def num_edges(self):
        return self.data.shape[1]

    def sort_by(self, order):
        """(a new EdgeIndex sorted stably by 'row' or 'col', the perm)."""
        key = self.data[0] if order == "row" else self.data[1]
        perm = np.argsort(key, kind="stable")
        return EdgeIndex(self.data[:, perm], self.sparse_size, order), perm

    def _compressed(self, order):
        srt, perm = ((self, np.arange(self.num_edges))
                     if self.sort_order == order else self.sort_by(order))
        axis = 0 if order == "row" else 1
        return (ind2ptr_np(srt.data[axis], self.sparse_size[axis]),
                srt.data[1 - axis], perm)

    def get_csr(self):
        """(rowptr, col, perm): cached."""
        if self._rowptr is None:
            self._rowptr, self._csr_col, self._perm_row = \
                self._compressed("row")
        return self._rowptr, self._csr_col, self._perm_row

    def get_csc(self):
        """(colptr, row, perm): cached."""
        if self._colptr is None:
            self._colptr, self._csc_row, self._perm_col = \
                self._compressed("col")
        return self._colptr, self._csc_row, self._perm_col

    def __array__(self, dtype=None, copy=None):
        return self.data if dtype is None else self.data.astype(dtype)

    def __getitem__(self, idx):
        return self.data[idx]

    def __repr__(self):
        return (f"EdgeIndex({list(self.data.shape)}, "
                f"sparse_size={self.sparse_size}, "
                f"sort_order={self.sort_order})")
