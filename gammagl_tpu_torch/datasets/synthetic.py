"""Synthetic datasets for tests, benchmarks and offline work (counterpart
of `gammagl_tpu/datasets/synthetic.py`): deterministic graphs with
Planetoid's fields (x, edge_index, y, train / val / test masks), drawn
from the same numpy stream as the JAX package's, so both packages get
the same graph from the same seed."""

import os.path as osp
import tempfile

import numpy as np

from gammagl_tpu_torch.data.dataset import InMemoryDataset
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.undirected import to_undirected

__all__ = ["StochasticBlockModelDataset", "synthetic_community_graph"]


def synthetic_community_graph(num_nodes=200, num_classes=4, feat_dim=32,
                              avg_degree=10, p_intra=0.9, seed=0,
                              feature_signal=0.3):
    """Stochastic-block-model graph whose communities are the labels:
    ``p_intra`` of the edges stay in their class, the features carry a
    ``feature_signal`` of the class, and 40 / 20 / 40% of the nodes are
    train / val / test."""
    rng = np.random.default_rng(seed)
    per = num_nodes // num_classes
    y = np.minimum(np.arange(num_nodes) // per, num_classes - 1)
    E = num_nodes * avg_degree // 2
    src = rng.integers(0, num_nodes, E)
    same = rng.random(E) < p_intra
    tgt_class = np.where(same, y[src],
                         (y[src] + rng.integers(1, num_classes, E))
                         % num_classes)
    dst = np.minimum(tgt_class * per + rng.integers(0, per, E),
                     num_nodes - 1)
    ei = to_undirected(np.stack([src, dst]), num_nodes=num_nodes)
    x = (rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
         + feature_signal * np.eye(num_classes, feat_dim,
                                   dtype=np.float32)[y])
    g = Graph(x=x, edge_index=ei, y=y.astype(np.int64))
    perm = rng.permutation(num_nodes)
    n_tr, n_va = int(0.4 * num_nodes), int(0.2 * num_nodes)
    for name, idx in (("train_mask", perm[:n_tr]),
                      ("val_mask", perm[n_tr:n_tr + n_va]),
                      ("test_mask", perm[n_tr + n_va:])):
        mask = np.zeros(num_nodes, bool)
        mask[idx] = True
        g[name] = mask
    return g


class StochasticBlockModelDataset(InMemoryDataset):
    """`synthetic_community_graph` as a one-graph dataset; processes
    without a download (root default: ``ggl_tpu_sbm`` in the temporary
    directory)."""

    def __init__(self, root=None, num_nodes=200, num_classes=4,
                 feat_dim=32, seed=0, transform=None, pre_transform=None,
                 force_reload=False):
        self.cfg = (num_nodes, num_classes, feat_dim, seed)
        super().__init__(
            root or osp.join(tempfile.gettempdir(), "ggl_tpu_sbm"),
            transform, pre_transform, force_reload=force_reload)

    @property
    def raw_file_names(self):
        return []

    @property
    def processed_file_names(self):
        n, c, f, s = self.cfg
        return f"sbm_{n}_{c}_{f}_{s}_torch.pkl"

    def download(self):
        pass

    def process(self):
        n, c, f, s = self.cfg
        data = synthetic_community_graph(n, c, f, seed=s)
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = self.collate([data])
        self.save_data(self.data, self.processed_paths[0])
