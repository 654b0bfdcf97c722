"""Graph: the homogeneous graph container (counterpart of
`gammagl_tpu/data/graph.py`).

Attributes live in one flat mapping. The structure stays on the host:
``edge_index`` is a (2, E) numpy array, from which `csr_plan()` builds the
destination-sorted CSR once. Tensors for the device are made by the
caller (or by `InferenceSession`), not by the container.
"""

import numpy as np

from gammagl_tpu_torch.ops.cuda import build_csr_plan_blocked
from gammagl_tpu_torch.utils.loop import add_self_loops

__all__ = ["Graph"]


class Graph:
    """``x`` (N, F) node features, ``edge_index`` (2, E) src/dst rows,
    plus any named attributes (``edge_attr``, ``y``, masks, ...)."""

    def __init__(self, x=None, edge_index=None, edge_attr=None, y=None,
                 num_nodes=None, **kwargs):
        store = {}
        for k, v in dict(x=x, edge_index=edge_index, edge_attr=edge_attr,
                         y=y, **kwargs).items():
            if v is not None:
                store[k] = v
        object.__setattr__(self, "_store", store)
        object.__setattr__(self, "_num_nodes", num_nodes)
        object.__setattr__(self, "_csr_plan", None)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key):
        store = self.__dict__.get("_store")
        if store is not None and key in store:
            return store[key]
        raise AttributeError(key)

    def __setattr__(self, key, value):
        if key.startswith("_") or key == "num_nodes":
            object.__setattr__(self, key, value)
        else:
            self._store[key] = value

    # -- sizes --------------------------------------------------------------
    @property
    def num_nodes(self):
        if self._num_nodes is not None:
            return self._num_nodes
        x = self._store.get("x")
        if x is not None:
            return int(x.shape[0])
        ei = self._store.get("edge_index")
        if ei is not None:
            return int(np.asarray(ei).max()) + 1
        return None

    @num_nodes.setter
    def num_nodes(self, v):
        object.__setattr__(self, "_num_nodes", v)

    @property
    def num_edges(self):
        ei = self._store.get("edge_index")
        return int(ei.shape[1]) if ei is not None else 0

    # -- graph ops ----------------------------------------------------------
    def add_self_loop(self, n_loops=1):
        """A copy with (i, i) edges appended for every node (reference:
        gammagl/data/graph.py:577); ``edge_attr`` rows are filled with 1."""
        ei, ea = add_self_loops(np.asarray(self.edge_index),
                                self._store.get("edge_attr"),
                                num_nodes=self.num_nodes, n_loops=n_loops)
        g = self.clone()
        g.edge_index = ei
        if ea is not None:
            g.edge_attr = ea
        return g

    def csr_plan(self, R=128, ET=None, num_src_blocks=None, window=True):
        """Cached destination-sorted CSR of ``edge_index`` (a `CSRPlan`).

        The keywords are those of the JAX package's TPU tiling; the CSR
        read by the card needs none of them, and they are ignored.
        """
        if self._csr_plan is None:
            ei = np.asarray(self.edge_index)
            object.__setattr__(self, "_csr_plan", build_csr_plan_blocked(
                ei[0], ei[1], self.num_nodes, R=R, ET=ET,
                num_src_blocks=num_src_blocks, window=window))
        return self._csr_plan

    def clone(self):
        """Shallow copy of the attributes; the cached plan is not shared."""
        g = Graph(num_nodes=self._num_nodes)
        g._store.update(self._store)
        return g

    def __repr__(self):
        fields = [f"{k}={list(v.shape)}" if hasattr(v, "shape") else
                  f"{k}={v}" for k, v in self._store.items()]
        return f"Graph({', '.join(fields)})"
