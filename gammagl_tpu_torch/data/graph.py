"""Graph: the homogeneous graph container (counterpart of
`gammagl_tpu/data/graph.py`).

Attributes live in one flat mapping. The structure stays on the host:
``edge_index`` is a (2, E) numpy array, from which `csr_plan()` builds the
destination-sorted CSR once, and `auto_plan()` picks between it and the
block-pair layouts; `reorder_rcm()`, `reorder_cluster()` and
`reorder_best()` relabel the nodes for the latter. Tensors for the device
are made by the caller (or by `InferenceSession`), not by the container.
"""

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda import (build_block_pair_plan,
                                        build_csr_plan_blocked,
                                        build_hybrid_plan)
from gammagl_tpu_torch.ops.cuda.block_pair import padded_fill, pair_occupancy
from gammagl_tpu_torch.parallel import cluster_permutation, reorder_bandwidth
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
        object.__setattr__(self, "_bp_plans", {})  # (R, S, ET) -> (fill, plan)

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

    def clone(self):
        """Shallow copy of the attributes; no cached plan is shared."""
        g = Graph(num_nodes=self._num_nodes)
        g._store.update(self._store)
        return g

    def __repr__(self):
        fields = [f"{k}={list(v.shape)}" if hasattr(v, "shape") else
                  f"{k}={v}" for k, v in self._store.items()]
        return f"Graph({', '.join(fields)})"
