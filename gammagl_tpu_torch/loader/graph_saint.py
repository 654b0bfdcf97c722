"""GraphSAINT samplers, Zeng et al. 2020 (counterpart of
`gammagl_tpu/loader/graph_saint.py`).

Reference: gammagl/loader/graph_saint.py:15,66,75: node and random-walk
samplers, and normalisation coefficients estimated over pre-sampling
runs (``sample_coverage``) drawn from the sampler's own ``default_rng``.
Host numpy.
"""

import numpy as np

from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.ops.sparse import ind2ptr_np
from gammagl_tpu_torch.utils.subgraph import subgraph

__all__ = ["GraphSAINTSampler", "GraphSAINTNodeSampler",
           "GraphSAINTRandomWalkSampler"]


class GraphSAINTSampler:
    def __init__(self, graph, batch_size, num_steps=1, sample_coverage=0,
                 seed=None):
        self.graph = graph.numpy() if hasattr(graph, "numpy") else graph
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.sample_coverage = sample_coverage
        self.rng = np.random.default_rng(seed)
        self.N = graph.num_nodes
        self.E = graph.num_edges
        if sample_coverage > 0:
            self.node_norm, self.edge_norm = self._compute_norm()

    def _sample_nodes(self):
        raise NotImplementedError

    def _compute_norm(self):
        node_count = np.zeros(self.N)
        edge_count = np.zeros(self.E)
        total = 0
        while total < self.N * self.sample_coverage:
            nodes = self._sample_nodes()
            node_count[nodes] += 1
            _, _, emask = subgraph(nodes, self.graph.edge_index,
                                   num_nodes=self.N)
            edge_count[emask] += 1
            total += len(nodes)
        n_runs = max(1, total // max(1, self.batch_size))
        ei = np.asarray(self.graph.edge_index)
        # lambda_e / lambda_v estimates (reference graph_saint.py:75)
        edge_norm = node_count[ei[1]] / np.maximum(edge_count, 1)
        node_norm = n_runs / np.maximum(node_count, 1) / self.N
        return node_norm, edge_norm

    def __len__(self):
        return self.num_steps

    def __iter__(self):
        for _ in range(self.num_steps):
            nodes = np.unique(self._sample_nodes())
            ei, _, emask = subgraph(nodes, self.graph.edge_index,
                                    relabel_nodes=True, num_nodes=self.N)
            sub = Graph(num_nodes=len(nodes), edge_index=ei)
            for k, v in self.graph.items():
                v = np.asarray(v)
                if v.ndim > 0 and v.shape[0] == self.N:
                    sub[k] = v[nodes]
            sub.n_id = nodes
            if self.sample_coverage > 0:
                sub.node_norm = self.node_norm[nodes]
                sub.edge_norm = self.edge_norm[emask]
            yield sub


class GraphSAINTNodeSampler(GraphSAINTSampler):
    def _sample_nodes(self):
        return self.rng.integers(0, self.N, self.batch_size)


class GraphSAINTRandomWalkSampler(GraphSAINTSampler):
    def __init__(self, graph, batch_size, walk_length=2, num_steps=1,
                 sample_coverage=0, seed=None):
        self.walk_length = walk_length
        # the CSR first: the norms' pre-sampling walks on it (the JAX
        # sampler builds it after them, so sample_coverage > 0 raises
        # there; ROADMAP C25)
        ei = np.asarray(graph.edge_index)
        order = np.argsort(ei[0], kind="stable")
        self.rowptr = ind2ptr_np(ei[0][order], graph.num_nodes)
        self.col = ei[1][order]
        super().__init__(graph, batch_size, num_steps, sample_coverage,
                         seed)

    def _sample_nodes(self):
        start = self.rng.integers(0, self.N, self.batch_size)
        nodes = [start]
        cur = start
        for _ in range(self.walk_length):
            nxt = cur.copy()
            for i, u in enumerate(cur):
                lo, hi = self.rowptr[u], self.rowptr[u + 1]
                if hi > lo:
                    nxt[i] = self.col[self.rng.integers(lo, hi)]
            nodes.append(nxt)
            cur = nxt
        return np.concatenate(nodes)
