"""Reddit (232,965 posts, 114M edges), the minibatch-sampling benchmark
(counterpart of `gammagl_tpu/datasets/reddit.py`).

Reference: gammagl/datasets/reddit.py (data.dgl.ai/dataset/reddit.zip).
Raw layout: ``raw/reddit_data.npz`` (``feature``, ``label``,
``node_types``) and ``raw/reddit_graph.npz`` (a scipy sparse matrix). The
edges are coalesced; ``node_types`` 1 / 2 / 3 are the train / val / test
masks.
"""

import os
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data.dataset import InMemoryDataset
from gammagl_tpu_torch.data.download import download_url, extract_zip
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.coalesce import coalesce

__all__ = ["Reddit"]


class Reddit(InMemoryDataset):
    url = "https://data.dgl.ai/dataset/reddit.zip"

    @property
    def raw_file_names(self):
        return ["reddit_data.npz", "reddit_graph.npz"]

    def download(self):
        path = download_url(self.url, self.raw_dir)
        extract_zip(path, self.raw_dir)
        os.unlink(path)

    def process(self):
        import scipy.sparse as sp

        data = np.load(osp.join(self.raw_dir, "reddit_data.npz"))
        x = data["feature"].astype(np.float32)
        y = data["label"].astype(np.int64)
        split = np.asarray(data["node_types"])
        adj = sp.load_npz(osp.join(self.raw_dir, "reddit_graph.npz")).tocoo()
        edge = coalesce(np.stack([adj.row, adj.col]).astype(np.int64),
                        num_nodes=x.shape[0])
        g = Graph(edge_index=edge, x=x, y=y)
        g.train_mask = split == 1
        g.val_mask = split == 2
        g.test_mask = split == 3
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])
