"""Disjoint-union batching of graphs (counterpart of
`gammagl_tpu/data/batch.py`).

Reference: gammagl/data/batch.py:13 `BatchGraph.from_data_list:55`,
`to_data_list:154`: attributes are concatenated along `__cat_dim__`,
index-valued ones offset by the running sum of `__inc__`, and the slices
kept for unbatching. Host numpy, as in the JAX package; the result is a
`Graph`, so `csr_plan()` gives the batch's plan for the kernels.
"""

from typing import List

import numpy as np

from gammagl_tpu_torch.data.graph import Graph, _host

__all__ = ["BatchGraph"]


class BatchGraph(Graph):
    """A `Graph` formed as the disjoint union of a list of graphs, with a
    ``batch`` vector mapping each node to its graph and ``ptr`` the node
    offset of each graph."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, "_slices", None)
        object.__setattr__(self, "_num_graphs", None)

    @property
    def num_graphs(self):
        return self._num_graphs

    @classmethod
    def from_data_list(cls, data_list: List[Graph], follow_batch=None,
                       exclude_keys=None):
        """Batch ``data_list``: the keys of its first graph but
        ``exclude_keys``; a graph-level scalar (a class label) becomes one
        row per graph; ``follow_batch`` keys get a ``<key>_batch`` vector
        of graph ids along their cat dim."""
        exclude = set(exclude_keys or ())
        keys = [k for k in data_list[0].keys() if k not in exclude]
        batch = cls()
        slices = {k: [0] for k in keys}
        incs = {k: [0] for k in keys}
        parts = {k: [] for k in keys}
        batch_vec, node_counts = [], []
        for i, g in enumerate(data_list):
            n = g.num_nodes
            node_counts.append(n)
            batch_vec.append(np.full(n, i, dtype=np.int64))
            for k in keys:
                v = np.asarray(_host(g[k]))
                if v.ndim == 0:
                    v = v.reshape(1)
                inc = incs[k][-1]
                if g.__inc__(k) != 0:
                    v = v + inc
                parts[k].append(v)
                slices[k].append(slices[k][-1] + v.shape[g.__cat_dim__(k)])
                incs[k].append(inc + g.__inc__(k))
        for k in keys:
            batch[k] = np.concatenate(parts[k],
                                      axis=data_list[0].__cat_dim__(k))
        batch["batch"] = np.concatenate(batch_vec)
        batch["ptr"] = np.cumsum([0] + node_counts).astype(np.int64)
        for k in follow_batch or ():
            if k in keys:
                batch[f"{k}_batch"] = np.concatenate([
                    np.full(np.asarray(_host(g[k])).shape[g.__cat_dim__(k)],
                            i, np.int64) for i, g in enumerate(data_list)])
        object.__setattr__(batch, "_slices",
                           {k: np.asarray(v) for k, v in slices.items()})
        object.__setattr__(batch, "_num_graphs", len(data_list))
        batch.num_nodes = int(sum(node_counts))
        return batch

    def to_data_list(self):
        """The batched graphs again, each with its own node ids."""
        if self._slices is None:
            raise RuntimeError(
                "BatchGraph was not created via from_data_list")
        out = []
        ptr = np.asarray(self["ptr"])
        for i in range(self._num_graphs):
            g = Graph()
            for k, sl in self._slices.items():
                v = np.asarray(_host(self[k]))
                piece = np.take(v, np.arange(sl[i], sl[i + 1]),
                                axis=self.__cat_dim__(k))
                if self.__inc__(k) != 0 or k == "edge_index":
                    piece = piece - ptr[i]
                g[k] = piece
            g.num_nodes = int(ptr[i + 1] - ptr[i])
            out.append(g)
        return out
