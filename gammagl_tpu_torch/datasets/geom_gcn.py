"""Geom-GCN text-format datasets: WebKB (Cornell/Texas/Wisconsin),
WikipediaNetwork (Chameleon/Squirrel), Actor.

Counterpart of `gammagl_tpu/datasets/geom_gcn.py` (reference:
gammagl/datasets/{webkb,wikipedia_network,actor}.py): a node feature and
label file and an edge list from the geom-gcn repo, with 10 pre-computed
split files. Actor's features are comma lists of active keyword indices.
The processed cache is the port's own (``data_torch.pkl``).
"""

import os.path as osp

import numpy as np

from gammagl_tpu_torch.data import InMemoryDataset, download_url
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.undirected import to_undirected

__all__ = ["WebKB", "WikipediaNetwork", "Actor"]

_GEOM_URL = ("https://raw.githubusercontent.com/graphdml-uiuc-jlu/"
             "geom-gcn/master")


class WebKB(InMemoryDataset):
    url = _GEOM_URL

    def __init__(self, root=None, name="cornell", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in ("cornell", "texas", "wisconsin")
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)

    @property
    def raw_dir(self):
        return osp.join(self.root, self.name, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, self.name, "processed")

    @property
    def raw_file_names(self):
        return (["out1_node_feature_label.txt", "out1_graph_edges.txt"]
                + [f"{self.name}_split_0.6_0.2_{i}.npz" for i in range(10)])

    def download(self):
        for f in self.raw_file_names[:2]:
            download_url(f"{self.url}/new_data/{self.name}/{f}",
                         self.raw_dir)
        for f in self.raw_file_names[2:]:
            download_url(f"{self.url}/splits/{f}", self.raw_dir)

    def _read_features(self):
        with open(self.raw_paths[0]) as f:
            lines = f.read().split("\n")[1:-1]
        xs = [[float(v) for v in line.split("\t")[1].split(",")]
              for line in lines]
        ys = [int(line.split("\t")[2]) for line in lines]
        return np.asarray(xs, np.float32), np.asarray(ys, np.int64)

    def _read_edges(self, num_nodes):
        with open(self.raw_paths[1]) as f:
            lines = f.read().split("\n")[1:-1]
        ei = np.asarray([[int(v) for v in line.split("\t")]
                         for line in lines], np.int64).T
        return to_undirected(ei, num_nodes=num_nodes)

    def _read_splits(self, num_nodes):
        train, val, test = [], [], []
        for path in self.raw_paths[2:]:
            with np.load(path) as s:
                train.append(s["train_mask"].astype(bool))
                val.append(s["val_mask"].astype(bool))
                test.append(s["test_mask"].astype(bool))
        return (np.stack(train, 1), np.stack(val, 1), np.stack(test, 1))

    def process(self):
        x, y = self._read_features()
        ei = self._read_edges(x.shape[0])
        g = Graph(x=x, y=y, edge_index=ei)
        g.train_mask, g.val_mask, g.test_mask = self._read_splits(x.shape[0])
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])


class WikipediaNetwork(WebKB):
    def __init__(self, root=None, name="chameleon", transform=None,
                 pre_transform=None, force_reload=False):
        name = name.lower()
        assert name in ("chameleon", "squirrel")
        self.name = name
        InMemoryDataset.__init__(self, root, transform, pre_transform,
                                 force_reload=force_reload)


class Actor(WebKB):
    """Actor co-occurrence graph (reference actor.py; features are sparse
    keyword indices)."""

    def __init__(self, root=None, transform=None, pre_transform=None,
                 force_reload=False):
        self.name = "film"
        InMemoryDataset.__init__(self, root, transform, pre_transform,
                                 force_reload=force_reload)

    @property
    def raw_file_names(self):
        return (["out1_node_feature_label.txt", "out1_graph_edges.txt"]
                + [f"film_split_0.6_0.2_{i}.npz" for i in range(10)])

    def _read_features(self):
        with open(self.raw_paths[0]) as f:
            lines = f.read().split("\n")[1:-1]
        dim = 932
        x = np.zeros((len(lines), dim), np.float32)
        ys = []
        for i, line in enumerate(lines):
            _, feats, label = line.split("\t")
            for v in feats.split(","):
                x[i, int(v)] = 1.0
            ys.append(int(label))
        return x, np.asarray(ys, np.int64)
