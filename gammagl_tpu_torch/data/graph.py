"""Graph: the homogeneous graph container (counterpart of
`gammagl_tpu/data/graph.py`).

Attributes live in one flat mapping (`BaseGraph`'s protocol, shared with
the `HeteroGraph` stores). The structure stays on the host: ``edge_index``
is a (2, E) numpy array, from which `csr_plan()` builds the
destination-sorted CSR once (`csc_plan()` the source-sorted one), and
`auto_plan()` picks between it and the block-pair layouts;
`reorder_rcm()`, `reorder_cluster()` and `reorder_best()` relabel the
nodes for the latter. `tensor()` gives a copy with tensors on the card
(or the device asked for); `numpy()` brings them back. The batching
protocol (`__cat_dim__`, `__inc__`) is the JAX package's, which
`BatchGraph.from_data_list` follows.
"""

import copy as _copy
import pickle

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda import (build_block_pair_plan,
                                        build_csr_plan_blocked,
                                        build_hybrid_plan)
from gammagl_tpu_torch.ops.cuda.block_pair import padded_fill, pair_occupancy
from gammagl_tpu_torch.parallel import cluster_permutation, reorder_bandwidth
from gammagl_tpu_torch.utils.degree import degree
from gammagl_tpu_torch.utils.device import to_device
from gammagl_tpu_torch.utils.loop import add_self_loops

__all__ = ["Graph", "BaseGraph", "load_pickle"]


def _is_array(v):
    return isinstance(v, (np.ndarray, torch.Tensor))


def _host(v):
    """A tensor as a numpy array on the host; anything else as it is."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


class BaseGraph:
    """The attribute mapping shared by `Graph` and the `HeteroGraph`
    stores: ``g.x`` and ``g["x"]`` name the same value."""

    def __init__(self, **kwargs):
        object.__setattr__(self, "_store", {k: v for k, v in kwargs.items()
                                            if v is not None})

    # -- mapping protocol ---------------------------------------------------
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

    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value):
        self._store[key] = value

    def __delitem__(self, key):
        del self._store[key]

    def __contains__(self, key):
        return key in self._store

    def keys(self):
        return self._store.keys()

    def items(self):
        return self._store.items()

    def values(self):
        return self._store.values()

    def to_dict(self):
        return dict(self._store)


class Graph(BaseGraph):
    """``x`` (N, F) node features, ``edge_index`` (2, E) src/dst rows,
    plus any named attributes (``edge_attr``, ``y``, masks, ...)."""

    def __init__(self, x=None, edge_index=None, edge_attr=None, y=None,
                 num_nodes=None, **kwargs):
        super().__init__(x=x, edge_index=edge_index, edge_attr=edge_attr,
                         y=y, **kwargs)
        object.__setattr__(self, "_num_nodes", num_nodes)
        self._clear_plans()

    def _clear_plans(self):
        object.__setattr__(self, "_csr_plan", None)
        object.__setattr__(self, "_csc_plan", None)
        object.__setattr__(self, "_bp_plans", {})  # (R, S, ET) -> (fill, plan)

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
            return int(np.asarray(_host(ei)).max()) + 1
        return None

    @num_nodes.setter
    def num_nodes(self, v):
        object.__setattr__(self, "_num_nodes", v)

    @property
    def num_edges(self):
        ei = self._store.get("edge_index")
        return int(ei.shape[1]) if ei is not None else 0

    @property
    def num_node_features(self):
        x = self._store.get("x")
        return int(x.shape[-1]) if x is not None else 0

    num_features = num_node_features

    @property
    def num_edge_features(self):
        ea = self._store.get("edge_attr")
        return int(ea.shape[-1]) if ea is not None and ea.ndim > 1 else 0

    # -- degree (reference graph.py:557-575) --------------------------------
    @property
    def in_degree(self):
        """Float32 in-degree of every node, where ``edge_index`` lives (a
        tensor on its device, numpy on the host); ids out of range, the
        pads of `pad_graph`, are dropped."""
        return degree(self.edge_index[1], self.num_nodes)

    @property
    def out_degree(self):
        """Float32 out-degree, as `in_degree`."""
        return degree(self.edge_index[0], self.num_nodes)

    # -- batching protocol (reference graph.py:85-107) ----------------------
    def __cat_dim__(self, key, value=None):
        return 1 if key == "edge_index" else 0

    def __inc__(self, key, value=None):
        if "index" in key or key == "face":
            return self.num_nodes
        return 0

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

    def sorted_edges(self, sort_by="dst"):
        """(edge_index sorted stably by destination or source, the
        permutation), on the host."""
        ei = np.asarray(_host(self.edge_index))
        perm = np.argsort(ei[1] if sort_by == "dst" else ei[0], kind="stable")
        return ei[:, perm], perm

    def csr_plan(self, R=128, ET=None, num_src_blocks=None, window=True):
        """Cached destination-sorted CSR of ``edge_index`` (a `CSRPlan`).

        The keywords are those of the JAX package's TPU tiling; the CSR
        read by the card needs none of them, and they are ignored.
        """
        if self._csr_plan is None:
            ei = np.asarray(_host(self.edge_index))
            object.__setattr__(self, "_csr_plan", build_csr_plan_blocked(
                ei[0], ei[1], self.num_nodes, R=R, ET=ET,
                num_src_blocks=num_src_blocks, window=window))
        return self._csr_plan

    def reorder_rcm(self):
        """Bandwidth-reducing (reverse Cuthill-McKee) node relabeling.

        Returns (graph', perm): graph' has every per-node attribute
        permuted and the edge ids remapped (new id i holds old node
        perm[i]); the edge order is kept. Run it once before `auto_plan()`:
        a banded adjacency is what the block-pair kernel needs."""
        perm, inv = reorder_bandwidth(np.asarray(self.edge_index),
                                      self.num_nodes)
        return self._permuted(perm, inv), perm

    def _permuted(self, perm, inv):
        n = self.num_nodes
        ei = np.asarray(self.edge_index)
        attrs = {}
        for k, v in self._store.items():
            if k == "edge_index":
                attrs[k] = inv[ei]
            elif hasattr(v, "shape") and len(v.shape) >= 1 and v.shape[0] == n:
                attrs[k] = (v[torch.from_numpy(perm).to(v.device)]
                            if isinstance(v, torch.Tensor)
                            else np.asarray(v)[perm])
            else:
                attrs[k] = v
        return Graph(num_nodes=n, **attrs)

    def reorder_cluster(self, rounds=8):
        """Community-clustering relabeling (label propagation,
        `parallel.partition.cluster_permutation`): nodes laid out
        cluster-contiguously, so the (dst block, src block) tiling of the
        block-pair kernel is dense on clustered graphs, where RCM's band
        is loose. Returns (graph', perm)."""
        perm, inv = cluster_permutation(np.asarray(self.edge_index),
                                        self.num_nodes, rounds=rounds)
        return self._permuted(perm, inv), perm

    def reorder_best(self, R=256, S=256, ET=256, rounds=8):
        """Try the natural, RCM and label-propagation orders and keep the
        one with the highest block-pair fill. Returns (graph', perm, name,
        fill); the natural order returns (self, identity, 'natural',
        fill)."""
        ei = np.asarray(self.edge_index)
        n = self.num_nodes

        def fill_of(e):
            return padded_fill(e.shape[1],
                               pair_occupancy(e[0], e[1], n, R, S)[1], ET)

        best = ("natural", np.arange(n), np.arange(n), fill_of(ei))
        for name, fn in (("rcm", lambda: reorder_bandwidth(ei, n)),
                         ("cluster", lambda: cluster_permutation(
                             ei, n, rounds=rounds))):
            try:
                perm, inv = fn()
            except Exception:  # scipy missing etc., as in the JAX package
                continue
            f = fill_of(inv[ei])
            if f > best[3]:
                best = (name, perm, inv, f)
        name, perm, inv, fill = best
        if name == "natural":
            return self, perm, name, fill
        return self._permuted(perm, inv), perm, name, fill

    def block_pair_fill(self, R=256, S=256, ET=256):
        """O(E) estimate of the block-pair plan's ``fill_ratio``: the
        (dst block, src block) pair counts, each padded to a multiple of
        ET, without building the plan."""
        ei = np.asarray(self.edge_index)
        _, counts = pair_occupancy(ei[0], ei[1], self.num_nodes, R, S)
        return padded_fill(ei.shape[1], counts, ET)

    def auto_plan(self, fill_threshold=0.8, R=256, S=256, ET=256,
                  hybrid_threshold=0.25):
        """The SpMM plan for this graph, by the JAX package's rule: a
        `BlockPairPlan` when the (dst block, src block) tiling fills to at
        least ``fill_threshold`` (typical after `reorder_rcm()` or
        `reorder_cluster()`); a `HybridPlan` when at least
        ``hybrid_threshold`` of the edges sit in pairs of 0.75 * ET edges or
        more (those go to the block-pair kernel, the tail to the CSR
        kernel); `csr_plan()` otherwise. Cached per (R, S, ET); the result
        goes into any conv's ``plan=``."""
        key = (R, S, ET)
        if key in self._bp_plans:
            return self._bp_plans[key][1]
        ei = np.asarray(self.edge_index)
        occupancy, counts = pair_occupancy(ei[0], ei[1], self.num_nodes, R,
                                           S)
        fill = padded_fill(ei.shape[1], counts, ET)
        if fill >= fill_threshold:
            plan = build_block_pair_plan(ei[0], ei[1], self.num_nodes, R=R,
                                         S=S, ET=ET)
        elif float((occupancy >= (3 * ET) // 4).mean()) >= hybrid_threshold:
            plan = build_hybrid_plan(ei[0], ei[1], self.num_nodes, R=R, S=S,
                                     ET=ET, occupancy=occupancy)
        else:
            plan = self.csr_plan()
        self._bp_plans[key] = (fill, plan)
        return plan

    def csc_plan(self, R=256, ET=None, num_src_blocks=None):
        """Cached source-sorted CSR (the transposed graph, the backward
        pass's): the port's plan builder on (dst, src). The keywords are
        the JAX package's TPU tiling, ignored as in `csr_plan`. Copies do
        not share it."""
        if self._csc_plan is None:
            ei = np.asarray(_host(self.edge_index))
            object.__setattr__(self, "_csc_plan", build_csr_plan_blocked(
                ei[1], ei[0], self.num_nodes, R=R, ET=ET,
                num_src_blocks=num_src_blocks))
        return self._csc_plan

    # -- conversion (reference graph.py:616,649) ----------------------------
    def tensor(self, device=None):
        """A copy with every array a tensor on ``device`` (None: the
        card); read-only memory maps are copied in slices
        (`utils.to_device`)."""
        g = self.clone()
        for k, v in g.items():
            if _is_array(v):
                g[k] = to_device(v, device)
        return g

    def numpy(self):
        """A copy with every tensor brought to the host as numpy."""
        g = self.clone()
        for k, v in g.items():
            if _is_array(v):
                g[k] = np.asarray(_host(v))
        return g

    def clone(self):
        """Shallow copy of the attributes; no cached plan is shared."""
        g = self.__class__()
        g._store.update(self._store)
        object.__setattr__(g, "_num_nodes", self._num_nodes)
        return g

    def copy(self):
        return self.clone()

    def deepcopy(self):
        """Deep copy of the attributes; no cached plan is shared."""
        g = self.__class__()
        object.__setattr__(g, "_store", _copy.deepcopy(self._store))
        object.__setattr__(g, "_num_nodes", self._num_nodes)
        return g

    def to_heterogeneous(self, node_type=None, edge_type=None,
                         node_type_names=None, edge_type_names=None):
        """Split into a `HeteroGraph` by ``node_type`` / ``edge_type``
        (reference: gammagl/data/graph.py:683). As in the JAX package, a
        relation's endpoint types are those of its first edge."""
        from gammagl_tpu_torch.data.heterograph import HeteroGraph
        ei = np.asarray(_host(self.edge_index))
        node_type = (np.zeros(self.num_nodes, np.int64) if node_type is None
                     else np.asarray(_host(node_type)))
        edge_type = (np.zeros(self.num_edges, np.int64) if edge_type is None
                     else np.asarray(_host(edge_type)))
        ntypes = node_type_names or [str(i) for i in
                                     range(int(node_type.max()) + 1)]
        out = HeteroGraph()
        local = np.zeros(self.num_nodes, np.int64)
        for i, nt in enumerate(ntypes):
            mask = node_type == i
            local[mask] = np.arange(mask.sum())
            if "x" in self:
                out[nt].x = np.asarray(_host(self.x))[mask]
            out[nt].num_nodes = int(mask.sum())
        n_et = int(edge_type.max()) + 1 if len(edge_type) else 0
        for j in range(n_et):
            sub = ei[:, edge_type == j]
            st = ntypes[int(node_type[sub[0, 0]])] if sub.size else ntypes[0]
            dt = ntypes[int(node_type[sub[1, 0]])] if sub.size else ntypes[0]
            name = (edge_type_names[j] if edge_type_names
                    else (st, f"e{j}", dt))
            out[name].edge_index = local[sub]
        return out

    def dump(self, path):
        """Pickle a numpy copy to ``path`` (reference graph.py:886)."""
        with open(path, "wb") as f:
            pickle.dump(self.numpy(), f)

    @staticmethod
    def load(path):
        """What `dump` wrote; a pickle of the JAX package's objects is
        refused before anything of that package is imported."""
        with open(path, "rb") as f:
            return load_pickle(f)

    def __repr__(self):
        fields = [f"{k}={list(v.shape)}" if hasattr(v, "shape") else
                  f"{k}={v}" for k, v in self._store.items()]
        return f"{self.__class__.__name__}({', '.join(fields)})"


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("gammagl_tpu", "jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"{module}.{name} is an object of the JAX package; this "
                "package reads only the files it wrote itself")
        return super().find_class(module, name)


def load_pickle(f):
    """Unpickle from the open file ``f``, refusing the JAX package's
    classes (a cache the JAX package wrote under the same root)."""
    return _PortUnpickler(f).load()
