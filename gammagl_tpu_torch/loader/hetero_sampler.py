"""Heterogeneous neighbour sampling and loading (counterpart of
`gammagl_tpu/loader/hetero_sampler.py`).

Reference: gammagl/loader/hetero_sampler.py:77 over the C++
`hetero_neighbor_sample` (gammagl/ops/sparse/cpu/neighbor_sample.cpp:125):
per-hop, per-edge-type fanout sampling with per-node-type relabelling,
yielding a typed subgraph. The C++ sampler (`csrc`) runs it, and raises
when it does not build; the numpy route runs only with ``use_ext=False``.
Node types without features (only edge endpoints) get their sizes from
the edges.
"""

from typing import Dict, Sequence, Union

import numpy as np

from gammagl_tpu_torch.data.heterograph import HeteroGraph
from gammagl_tpu_torch.ops.sparse import ind2ptr_np

__all__ = ["HeteroNeighborSampler", "HeteroNeighborLoader"]


class HeteroNeighborSampler:
    def __init__(self, hetero_graph: HeteroGraph,
                 num_neighbors: Union[Sequence[int], Dict],
                 seed=None, use_ext=True):
        self.graph = hetero_graph
        self.edge_types = hetero_graph.edge_types
        self.node_types = hetero_graph.node_types
        # node types that only appear as edge endpoints (featureless,
        # no store) still need slots in the per-type outputs
        for et in self.edge_types:
            for nt in (et[0], et[2]):
                if nt not in self.node_types:
                    self.node_types.append(nt)
        if not isinstance(num_neighbors, dict):
            num_neighbors = {et: list(num_neighbors)
                             for et in self.edge_types}
        self.num_neighbors = num_neighbors
        self.num_hops = max(len(v) for v in num_neighbors.values())
        self.rng = np.random.default_rng(seed)
        # per-edge-type CSC; per-type node counts inferred from edges
        # when the store has none (featureless node types are common)
        self._csc = {}
        self._n_per_type = {nt: (hetero_graph[nt].num_nodes or 0)
                            for nt in self.node_types}
        for et in self.edge_types:
            ei = np.asarray(hetero_graph[et].edge_index)
            n_dst = max(self._n_per_type[et[2]],
                        (int(ei[1].max()) + 1) if ei.shape[1] else 0)
            self._n_per_type[et[2]] = n_dst
            self._n_per_type[et[0]] = max(
                self._n_per_type[et[0]],
                (int(ei[0].max()) + 1) if ei.shape[1] else 0)
            order = np.argsort(ei[1], kind="stable")
            self._csc[et] = (ind2ptr_np(ei[1][order], n_dst),
                             ei[0][order], order)
        self._ext = None
        if use_ext:
            from gammagl_tpu_torch import csrc
            csrc.get_lib()  # raises, with the compiler's output, on failure
            self._ext = csrc

    def sample_from_nodes(self, seed_dict: Dict[str, np.ndarray]):
        """seed_dict: node-type -> seed ids. Returns (node_dict, row_dict,
        col_dict, edge_dict, batch_size_dict)."""
        if self._ext is not None:
            return self._sample_ext(seed_dict)
        return self._sample_np(seed_dict)

    def _sample_ext(self, seed_dict):
        nt_index = {nt: i for i, nt in enumerate(self.node_types)}
        csc = [self._csc[et] for et in self.edge_types]
        et_src = [nt_index[et[0]] for et in self.edge_types]
        et_dst = [nt_index[et[2]] for et in self.edge_types]
        fanouts = np.zeros((self.num_hops, len(self.edge_types)), np.int64)
        for j, et in enumerate(self.edge_types):
            fo = self.num_neighbors[et]
            fanouts[:len(fo), j] = fo
        seeds, stypes = [], []
        for nt, ids in seed_dict.items():
            for s in np.asarray(ids):
                seeds.append(int(s))
                stypes.append(nt_index[nt])
        # per-type hop-sum caps. The C sampler dedups seeds and keeps
        # per-type unique frontiers, so per hop an edge type emits at
        # most min(frontier[dst_type] * fanout, E_type) edges (all of
        # E_type when fanout < 0 = full neighborhood), and new nodes of
        # the src type are bounded by that count.
        n_per_type = np.array([self._n_per_type[nt]
                               for nt in self.node_types], np.int64)
        e_per_type = np.array([len(c[1]) for c in csc], np.int64)
        frontier = np.bincount(stypes, minlength=len(self.node_types)
                               ).astype(np.int64)
        frontier = np.minimum(frontier, n_per_type)
        ncap_t = frontier.copy()
        ecap_e = np.zeros(len(self.edge_types), np.int64)
        for h in range(self.num_hops):
            new = np.zeros(len(self.node_types), np.int64)
            for j in range(len(self.edge_types)):
                f = int(fanouts[h, j])
                if f == 0:
                    continue
                e_h = (int(e_per_type[j]) if f < 0
                       else int(frontier[et_dst[j]]) * f)
                e_h = min(e_h, int(e_per_type[j]))
                ecap_e[j] += e_h
                new[et_src[j]] += e_h
            frontier = np.minimum(new, n_per_type)
            ncap_t += frontier
        node_cap = int(np.minimum(ncap_t, n_per_type).max()) + 1
        edge_cap = int(max(1, ecap_e.max()))
        nodes, ncnt, rows, cols, edges, ecnt = \
            self._ext.hetero_neighbor_sample_c(
                csc, et_src, et_dst, fanouts, seeds, stypes,
                len(self.node_types),
                int(self.rng.integers(0, 2 ** 63)), node_cap, edge_cap)
        node_d = {nt: nodes[i, :ncnt[i]]
                  for i, nt in enumerate(self.node_types)}
        row_d = {et: rows[j, :ecnt[j]]
                 for j, et in enumerate(self.edge_types)}
        col_d = {et: cols[j, :ecnt[j]]
                 for j, et in enumerate(self.edge_types)}
        eid_d = {et: edges[j, :ecnt[j]]
                 for j, et in enumerate(self.edge_types)}
        return (node_d, row_d, col_d, eid_d,
                {nt: len(v) for nt, v in seed_dict.items()})

    def _sample_np(self, seed_dict: Dict[str, np.ndarray]):
        local = {nt: {} for nt in self.graph.node_types}
        nodes = {nt: [] for nt in self.graph.node_types}
        for nt, seeds in seed_dict.items():
            for s in np.asarray(seeds):
                local[nt][int(s)] = len(nodes[nt])
                nodes[nt].append(int(s))
        rows = {et: [] for et in self.edge_types}
        cols = {et: [] for et in self.edge_types}
        eids = {et: [] for et in self.edge_types}
        frontier = {nt: list(v) for nt, v in nodes.items()}
        for hop in range(self.num_hops):
            new_frontier = {nt: [] for nt in self.graph.node_types}
            for et in self.edge_types:
                fanouts = self.num_neighbors[et]
                if hop >= len(fanouts):
                    continue
                fanout = fanouts[hop]
                src_t, _, dst_t = et
                colptr, row, perm = self._csc[et]
                for dst in frontier.get(dst_t, []):
                    if dst >= len(colptr) - 1:
                        continue
                    lo, hi = colptr[dst], colptr[dst + 1]
                    deg = hi - lo
                    if deg == 0:
                        continue
                    if fanout < 0 or deg <= fanout:
                        take = np.arange(lo, hi)
                    else:
                        take = lo + self.rng.choice(deg, fanout,
                                                    replace=False)
                    for e in take:
                        s = int(row[e])
                        if s not in local[src_t]:
                            local[src_t][s] = len(nodes[src_t])
                            nodes[src_t].append(s)
                            new_frontier[src_t].append(s)
                        rows[et].append(local[src_t][s])
                        cols[et].append(local[dst_t][dst])
                        eids[et].append(int(perm[e]))
            frontier = new_frontier
        return (
            {nt: np.asarray(v, np.int64) for nt, v in nodes.items()},
            {et: np.asarray(v, np.int64) for et, v in rows.items()},
            {et: np.asarray(v, np.int64) for et, v in cols.items()},
            {et: np.asarray(v, np.int64) for et, v in eids.items()},
            {nt: len(v) for nt, v in seed_dict.items()},
        )


class HeteroNeighborLoader:
    """Minibatch loader over one seed node type; yields typed subgraphs."""

    def __init__(self, hetero_graph, num_neighbors, input_nodes,
                 batch_size=128, shuffle=False, seed=None):
        self.graph = hetero_graph
        self.sampler = HeteroNeighborSampler(hetero_graph, num_neighbors,
                                             seed)
        self.seed_type, idx = input_nodes
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        self.input_nodes = idx
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return -(-len(self.input_nodes) // self.batch_size)

    def __iter__(self):
        order = self.input_nodes.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, len(order), self.batch_size):
            seeds = order[lo:lo + self.batch_size]
            node_d, row_d, col_d, eid_d, bs_d = \
                self.sampler.sample_from_nodes({self.seed_type: seeds})
            sub = HeteroGraph()
            for nt, ids in node_d.items():
                if len(ids) == 0:
                    continue
                store = self.graph[nt]
                sub[nt].n_id = ids
                sub[nt].num_nodes = len(ids)
                if "x" in store:
                    sub[nt].x = np.asarray(store.x)[ids]
                if "y" in store:
                    sub[nt].y = np.asarray(store.y)[ids]
            for et in row_d:
                if len(row_d[et]) == 0:
                    continue
                sub[et].edge_index = np.stack([row_d[et], col_d[et]])
                sub[et].e_id = eid_d[et]
            sub[self.seed_type].batch_size = bs_d[self.seed_type]
            yield sub
