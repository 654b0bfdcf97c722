"""Node-seeded minibatch loaders, PyG-NeighborLoader style (counterpart
of `gammagl_tpu/loader/node_loader.py`).

Reference: gammagl/loader/{node_loader,node_neighbor_loader}.py: seed
nodes -> sampler.sample_from_nodes -> the sampled subgraph with its
features gathered (`filter_graph`, loader/utils.py:49). Host numpy.
"""

import numpy as np

from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.sampler.neighbor_sampler import NeighborSampler

__all__ = ["NodeLoader", "NodeNeighborLoader", "filter_graph"]


def filter_graph(graph, sampler_out):
    """The sampled subgraph with its node and edge attributes gathered
    (reference loader/utils.py:49)."""
    sub = Graph(num_nodes=len(sampler_out.node))
    sub.edge_index = np.stack([sampler_out.row, sampler_out.col])
    sub.n_id = sampler_out.node
    sub.e_id = sampler_out.edge
    sub.batch_size = sampler_out.batch_size
    for k, v in graph.items():
        v = np.asarray(v)
        if v.ndim > 0 and v.shape[0] == graph.num_nodes:
            sub[k] = v[sampler_out.node]
        elif v.ndim > 0 and k != "edge_index" \
                and v.shape[0] == graph.num_edges:
            sub[k] = v[sampler_out.edge]
    return sub


class NodeLoader:
    """Batches of ``input_nodes`` (ids or a mask; None: every node),
    shuffled by a ``default_rng(seed)``, each through ``sampler`` and
    `filter_graph`. ``presample_chunks`` > 1 samples that many batches a
    call where the sampler has ``sample_from_nodes_many``."""

    def __init__(self, graph, sampler, input_nodes=None, batch_size=1,
                 shuffle=False, drop_last=False, seed=None,
                 presample_chunks=1):
        self.graph = graph
        self.sampler = sampler
        if input_nodes is None:
            input_nodes = np.arange(graph.num_nodes)
        else:
            input_nodes = np.asarray(input_nodes)
            if input_nodes.dtype == bool:
                input_nodes = np.nonzero(input_nodes)[0]
        self.input_nodes = input_nodes
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.presample_chunks = presample_chunks
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.input_nodes)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        order = self.input_nodes.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        seed_batches = []
        for lo in range(0, len(order), self.batch_size):
            seeds = order[lo:lo + self.batch_size]
            if self.drop_last and len(seeds) < self.batch_size:
                break
            seed_batches.append(seeds)
        if self.presample_chunks > 1 and hasattr(
                self.sampler, "sample_from_nodes_many"):
            for lo in range(0, len(seed_batches), self.presample_chunks):
                chunk = seed_batches[lo:lo + self.presample_chunks]
                for out in self.sampler.sample_from_nodes_many(chunk):
                    yield filter_graph(self.graph, out)
        else:
            for seeds in seed_batches:
                out = self.sampler.sample_from_nodes(seeds)
                yield filter_graph(self.graph, out)


class NodeNeighborLoader(NodeLoader):
    """NodeLoader with a NeighborSampler built in
    (reference node_neighbor_loader.py:10)."""

    def __init__(self, graph, num_neighbors, input_nodes=None, batch_size=1,
                 shuffle=False, replace=False, drop_last=False, seed=None,
                 presample_chunks=1):
        sampler = NeighborSampler(np.asarray(graph.edge_index),
                                  graph.num_nodes, num_neighbors,
                                  replace=replace, seed=seed)
        super().__init__(graph, sampler, input_nodes, batch_size, shuffle,
                         drop_last, seed, presample_chunks)
