"""HeteroGraph: typed node and edge stores (counterpart of
`gammagl_tpu/data/heterograph.py`).

Node stores are keyed by type name, edge stores by (src_type, relation,
dst_type). As `Graph`, it keeps the structure on the host in numpy and
builds each relation's `CSRPlan` once (`csr_plans`); `tensor()` moves the
stores' arrays to the card, `to_homogeneous()` flattens the stores into
one `Graph`.

    g = HeteroGraph()
    g["paper"].x = x_paper
    g[("author", "writes", "paper")].edge_index = ei
    plan_dict = g.csr_plans()
"""

import numpy as np

from gammagl_tpu_torch.data.graph import BaseGraph, Graph, _host, _is_array
from gammagl_tpu_torch.ops.cuda import build_csr_plan
from gammagl_tpu_torch.utils.device import to_device

__all__ = ["HeteroGraph"]


class _Store(BaseGraph):
    """The attributes of one node or edge type (``x``, ``edge_index``,
    ``y``, masks, ...)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        object.__setattr__(self, "_num_nodes", None)

    @property
    def num_nodes(self):
        if self._num_nodes is not None:
            return self._num_nodes
        x = self._store.get("x")
        return int(x.shape[0]) if x is not None else None

    @num_nodes.setter
    def num_nodes(self, v):
        object.__setattr__(self, "_num_nodes", v)

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

    def __init__(self, mapping=None, **kwargs):
        self._node_stores = {}
        self._edge_stores = {}
        self._globals = {}
        self._csr_plans = {}
        for key, attrs in list((mapping or {}).items()) + list(
                kwargs.items()):
            for name, value in attrs.items():
                self[key][name] = value

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

    def get_node_store(self, key):
        return self[key]

    def get_edge_store(self, src, rel, dst):
        return self[(src, rel, dst)]

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
                ei = np.asarray(_host(store.edge_index))
                cache[et] = build_csr_plan(ei[0], ei[1], n_dst, num_src=n_src,
                                           window=window)
        return cache

    def to_homogeneous(self, node_attrs=("x",), add_node_type=True,
                       add_edge_type=True):
        """One `Graph` of every typed store (reference heterograph.py:494):
        node types laid out one after the other in `node_types` order,
        ``node_type`` / ``edge_type`` vectors, and ``x`` when every node
        type has features of one width. Host numpy, as in the JAX
        package."""
        offsets, cursor = {}, 0
        ntypes = self.node_types
        for nt in ntypes:
            offsets[nt] = cursor
            cursor += self[nt].num_nodes or 0
        node_type = np.zeros(cursor, np.int64)
        for i, nt in enumerate(ntypes):
            node_type[offsets[nt]:offsets[nt] + (self[nt].num_nodes or 0)] = i
        eis, etypes = [], []
        for j, (et, store) in enumerate(self.edge_items()):
            ei = np.asarray(_host(store.edge_index))
            eis.append(np.stack([ei[0] + offsets[et[0]],
                                 ei[1] + offsets[et[2]]]))
            etypes.append(np.full(ei.shape[1], j, np.int64))
        g = Graph(num_nodes=cursor)
        if eis:
            g.edge_index = np.concatenate(eis, axis=1)
            if add_edge_type:
                g.edge_type = np.concatenate(etypes)
        if add_node_type:
            g.node_type = node_type
        xs = [np.asarray(_host(self[nt].x)) for nt in ntypes
              if "x" in self[nt]]
        if len(xs) == len(ntypes) and xs and all(
                x.shape[1:] == xs[0].shape[1:] for x in xs):
            g.x = np.concatenate(xs, axis=0)
        return g

    def _stores(self):
        return list(self._node_stores.values()) + list(
            self._edge_stores.values())

    def tensor(self, device=None):
        """Every array of every store a tensor on ``device`` (None: the
        card), in place, as the JAX package's; returns the graph."""
        for s in self._stores():
            for k, v in s.items():
                if _is_array(v):
                    s[k] = to_device(v, device)
        return self

    def numpy(self):
        """Every tensor back on the host as numpy, in place."""
        for s in self._stores():
            for k, v in s.items():
                if _is_array(v):
                    s[k] = np.asarray(_host(v))
        return self

    def __repr__(self):
        parts = [f"{nt}: " + str({k: tuple(getattr(v, "shape", ()))
                                  for k, v in s.items()})
                 for nt, s in self._node_stores.items()]
        parts += [f"{et}: E={s.num_edges}"
                  for et, s in self._edge_stores.items()]
        return "HeteroGraph(\n  " + "\n  ".join(parts) + "\n)"
