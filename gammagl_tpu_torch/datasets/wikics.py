"""WikiCS (counterpart of `gammagl_tpu/datasets/wikics.py`; reference:
gammagl/datasets/wikics.py): a json graph with 20 train / val / stopping
mask columns. The processed cache is the port's own
(``data_torch.pkl``)."""

import json
import os.path as osp
from itertools import chain

import numpy as np

from gammagl_tpu_torch.data import InMemoryDataset, download_url
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.undirected import to_undirected

__all__ = ["WikiCS"]


class WikiCS(InMemoryDataset):
    url = "https://github.com/pmernyei/wiki-cs-dataset/raw/master/dataset"

    def __init__(self, root=None, is_undirected=True, transform=None,
                 pre_transform=None, force_reload=False):
        self.is_undirected = is_undirected
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)

    @property
    def raw_file_names(self):
        return ["data.json"]

    def download(self):
        for name in self.raw_file_names:
            download_url(f"{self.url}/{name}", self.raw_dir)

    def process(self):
        with open(self.raw_paths[0]) as f:
            data = json.load(f)
        x = np.asarray(data["features"], np.float32)
        y = np.asarray(data["labels"], np.int64)
        edges = list(chain(*[[(i, j) for j in js]
                             for i, js in enumerate(data["links"])]))
        ei = np.asarray(edges, np.int64).T
        if self.is_undirected:
            ei = to_undirected(ei, num_nodes=x.shape[0])
        g = Graph(x=x, y=y, edge_index=ei)
        g.train_mask = np.asarray(data["train_masks"], bool).T
        g.val_mask = np.asarray(data["val_masks"], bool).T
        g.test_mask = np.asarray(data["test_mask"], bool)
        g.stopping_mask = np.asarray(data["stopping_masks"], bool).T
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])
