"""Edge-seeded loaders for link prediction (counterpart of
`gammagl_tpu/loader/link_loader.py`).

Reference: gammagl/loader/{link_loader,link_neighbor_loader}.py: seed
edges and optional negative sampling (``neg_sampling_ratio``,
link_loader.py:67-99), the neighbourhood sampled around both endpoints.
"""

import numpy as np

from gammagl_tpu_torch.loader.node_loader import filter_graph
from gammagl_tpu_torch.sampler.neighbor_sampler import NeighborSampler

__all__ = ["LinkLoader", "LinkNeighborLoader"]


class LinkLoader:
    def __init__(self, graph, sampler, edge_label_index=None,
                 edge_label=None, neg_sampling_ratio=0.0, batch_size=1,
                 shuffle=False, drop_last=False, seed=None):
        self.graph = graph
        self.sampler = sampler
        if edge_label_index is None:
            edge_label_index = np.asarray(graph.edge_index)
        self.edge_label_index = np.asarray(edge_label_index)
        self.edge_label = (np.asarray(edge_label) if edge_label is not None
                           else None)
        self.neg_sampling_ratio = neg_sampling_ratio
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = self.edge_label_index.shape[1]
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        E = self.edge_label_index.shape[1]
        order = np.arange(E)
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, E, self.batch_size):
            idx = order[lo:lo + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            pos = self.edge_label_index[:, idx]
            label = (self.edge_label[idx] if self.edge_label is not None
                     else np.ones(len(idx)))
            if self.neg_sampling_ratio > 0:
                n_neg = int(len(idx) * self.neg_sampling_ratio)
                neg = np.stack([
                    self.rng.integers(0, self.graph.num_nodes, n_neg),
                    self.rng.integers(0, self.graph.num_nodes, n_neg)])
                pos = np.concatenate([pos, neg], axis=1)
                label = np.concatenate([label, np.zeros(n_neg)])
            seeds = np.unique(pos.reshape(-1))
            out = self.sampler.sample_from_nodes(seeds)
            sub = filter_graph(self.graph, out)
            relabel = {int(n): i for i, n in enumerate(out.node)}
            sub.edge_label_index = np.vectorize(relabel.get)(pos)
            sub.edge_label = label
            yield sub


class LinkNeighborLoader(LinkLoader):
    def __init__(self, graph, num_neighbors, edge_label_index=None,
                 edge_label=None, neg_sampling_ratio=0.0, batch_size=1,
                 shuffle=False, replace=False, drop_last=False, seed=None):
        sampler = NeighborSampler(np.asarray(graph.edge_index),
                                  graph.num_nodes, num_neighbors,
                                  replace=replace, seed=seed)
        super().__init__(graph, sampler, edge_label_index, edge_label,
                         neg_sampling_ratio, batch_size, shuffle, drop_last,
                         seed)
