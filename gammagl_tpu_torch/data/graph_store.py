"""GraphStore: a topology backend that converts between layouts
(counterpart of `gammagl_tpu/data/graph_store.py`; reference
gammagl/data/graph_store.py: `EdgeLayout` :47, `EdgeAttr` :59). Host
numpy on the port's `ops/sparse.py` helpers."""

import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from gammagl_tpu_torch.data.graph import _host
from gammagl_tpu_torch.ops.sparse import ind2ptr_np, ptr2ind_np

__all__ = ["EdgeLayout", "EdgeAttr", "GraphStore", "InMemoryGraphStore"]


class EdgeLayout(enum.Enum):
    COO = "coo"
    CSR = "csr"
    CSC = "csc"


@dataclasses.dataclass
class EdgeAttr:
    """Address of an edge index (reference graph_store.py:59)."""

    edge_type: Any = None
    layout: EdgeLayout = EdgeLayout.COO
    is_sorted: bool = False
    size: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if isinstance(self.layout, str):
            self.layout = EdgeLayout(self.layout)


class GraphStore:
    """Abstract topology backend: subclasses define `_put_edge_index`,
    `_get_edge_index` and `get_all_edge_attrs`."""

    def _put_edge_index(self, edge_index, attr: EdgeAttr) -> bool:
        raise NotImplementedError

    def _get_edge_index(self, attr: EdgeAttr):
        raise NotImplementedError

    def get_all_edge_attrs(self) -> List[EdgeAttr]:
        raise NotImplementedError

    def put_edge_index(self, edge_index, *args, **kwargs) -> bool:
        return self._put_edge_index(edge_index, EdgeAttr(*args, **kwargs))

    def get_edge_index(self, *args, **kwargs):
        attr = EdgeAttr(*args, **kwargs)
        out = self._get_edge_index(attr)
        if out is None:
            raise KeyError(attr.edge_type)
        return out


class InMemoryGraphStore(GraphStore):
    """Keeps COO rows and columns; converts to the layout asked for on
    read (CSR: (rowptr, col) sorted stably by row; CSC: (colptr, row))."""

    def __init__(self):
        self._store: Dict[Any, Tuple[np.ndarray, np.ndarray,
                                     Optional[Tuple[int, int]]]] = {}

    def _put_edge_index(self, edge_index, attr):
        a, b = (np.asarray(_host(v)) for v in edge_index)
        if attr.layout == EdgeLayout.COO:
            row, col = a, b
        elif attr.layout == EdgeLayout.CSR:
            row, col = ptr2ind_np(a), b
        else:
            row, col = b, ptr2ind_np(a)
        self._store[attr.edge_type] = (row, col, attr.size)
        return True

    def _get_edge_index(self, attr):
        item = self._store.get(attr.edge_type)
        if item is None:
            return None
        row, col, size = item
        if attr.layout == EdgeLayout.COO:
            return np.stack([row, col])
        if attr.layout == EdgeLayout.CSR:
            m = size[0] if size else int(row.max()) + 1
            perm = np.argsort(row, kind="stable")
            return ind2ptr_np(row[perm], m), col[perm]
        m = size[1] if size else int(col.max()) + 1
        perm = np.argsort(col, kind="stable")
        return ind2ptr_np(col[perm], m), row[perm]

    def get_all_edge_attrs(self):
        return [EdgeAttr(et, EdgeLayout.COO, size=size)
                for et, (_, _, size) in self._store.items()]
