"""HeteroGraph: typed node and edge stores (counterpart of
`gammagl_tpu/data/heterograph.py`).

Node stores are keyed by type name, edge stores by (src_type, relation,
dst_type). As `Graph`, it keeps the structure on the host in numpy and
builds each relation's `CSRPlan` once (`csr_plans`); tensors for the device
are made by the caller.

    g = HeteroGraph()
    g["paper"].x = x_paper
    g[("author", "writes", "paper")].edge_index = ei
    plan_dict = g.csr_plans()
"""

import numpy as np

from gammagl_tpu_torch.ops.cuda import build_csr_plan

__all__ = ["HeteroGraph"]


class _Store:
    """The attributes of one node or edge type (``x``, ``edge_index``,
    ``y``, masks, ...)."""

    def __init__(self):
        object.__setattr__(self, "_store", {})
        object.__setattr__(self, "_num_nodes", None)

    def __getattr__(self, key):
        store = self.__dict__.get("_store")
        if store is not None and key in store:
            return store[key]
        raise AttributeError(key)

    def __setattr__(self, key, value):
        if key == "num_nodes":
            object.__setattr__(self, "_num_nodes", value)
        else:
            self._store[key] = value

    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value):
        self._store[key] = value

    def __contains__(self, key):
        return key in self._store

    def items(self):
        return self._store.items()

    @property
    def num_nodes(self):
        if self._num_nodes is not None:
            return self._num_nodes
        x = self._store.get("x")
        return int(x.shape[0]) if x is not None else None

    @property
    def num_edges(self):
        ei = self._store.get("edge_index")
        return int(ei.shape[1]) if ei is not None else 0


def _edge_key(key):
    if isinstance(key, tuple) and len(key) == 2:
        return (key[0], "to", key[1])
    return tuple(key) if isinstance(key, tuple) else key


class HeteroGraph:
    """Dict-of-stores heterogeneous graph:
    ``g['paper'].x = ...; g[('paper', 'cites', 'paper')].edge_index = ...``.
    A string key names a node type (or a graph-level value set with
    ``g[key] = value``); a 3-tuple (or a (src, dst) pair, relation "to")
    names an edge type."""

    def __init__(self):
        self._node_stores = {}
        self._edge_stores = {}
        self._globals = {}
        self._csr_plans = {}

    def __setitem__(self, key, value):
        self._globals[key] = value

    def __getitem__(self, key):
        if not isinstance(key, tuple) and key in self._globals:
            return self._globals[key]
        key = _edge_key(key)
        stores = (self._edge_stores if isinstance(key, tuple)
                  else self._node_stores)
        if key not in stores:
            stores[key] = _Store()
        return stores[key]

    def __contains__(self, key):
        key = _edge_key(key)
        return key in (self._edge_stores if isinstance(key, tuple)
                       else self._node_stores)

    def __getattr__(self, key):
        """``x_dict``, ``edge_index_dict``, ``y_dict``, ...: the attribute of
        every store that has it, keyed by type."""
        if key.endswith("_dict") and not key.startswith("_"):
            attr = key[:-5]
            return {k: s[attr] for k, s in (list(self._node_stores.items())
                                            + list(self._edge_stores.items()))
                    if attr in s}
        raise AttributeError(key)

    @property
    def node_types(self):
        return list(self._node_stores)

    @property
    def edge_types(self):
        return list(self._edge_stores)

    def metadata(self):
        return self.node_types, self.edge_types

    def node_items(self):
        return list(self._node_stores.items())

    def edge_items(self):
        return list(self._edge_stores.items())

    @property
    def num_nodes(self):
        return sum(s.num_nodes or 0 for s in self._node_stores.values())

    @property
    def num_edges(self):
        return sum(s.num_edges for s in self._edge_stores.values())

    def csr_plans(self, R=64, ET=128, window=True):
        """One `CSRPlan` per edge type with an ``edge_index`` and sized
        endpoint types, keyed as `edge_index_dict`: pass it as
        ``plan_dict`` to `HGTConv`. Cached per ``window``. ``R`` and
        ``ET`` are the JAX package's TPU tiling keywords, ignored;
        ``window`` is kept on each plan (`HGTConv` fuses on window plans,
        as the JAX layer does)."""
        del R, ET
        key = bool(window)
        cache = self._csr_plans.get(key)
        if cache is None:
            cache = self._csr_plans[key] = {}
            for et, store in self._edge_stores.items():
                if "edge_index" not in store:
                    continue
                n_src = self[et[0]].num_nodes
                n_dst = self[et[2]].num_nodes
                if n_src is None or n_dst is None:
                    continue
                ei = np.asarray(store.edge_index)
                cache[et] = build_csr_plan(ei[0], ei[1], n_dst, num_src=n_src,
                                           window=window)
        return cache

    def __repr__(self):
        parts = [f"{nt}: " + str({k: tuple(getattr(v, "shape", ()))
                                  for k, v in s.items()})
                 for nt, s in self._node_stores.items()]
        parts += [f"{et}: E={s.num_edges}"
                  for et, s in self._edge_stores.items()]
        return "HeteroGraph(\n  " + "\n  ".join(parts) + "\n)"
