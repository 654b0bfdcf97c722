"""PPI: protein-protein interaction graphs (multi-label, inductive).

Counterpart of `gammagl_tpu/datasets/ppi.py` (reference:
gammagl/datasets/ppi.py; data.dgl.ai/dataset/ppi.zip): per split a json
graph and npy features, labels and graph ids; each graph loses its
self-loops. The processed caches are the port's own
(``<split>_torch.pkl``).
"""

import json
import os
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data import InMemoryDataset, download_url, extract_zip
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.loop import remove_self_loops

__all__ = ["PPI"]


class PPI(InMemoryDataset):
    url = "https://data.dgl.ai/dataset/ppi.zip"

    def __init__(self, root=None, split="train", transform=None,
                 pre_transform=None, pre_filter=None, force_reload=False):
        assert split in ("train", "val", "test")
        self.split = split
        super().__init__(root, transform, pre_transform, pre_filter,
                         force_reload=force_reload)
        # load the split-specific processed file (the base class loads [0])
        idx = {"train": 0, "val": 1, "test": 2}[self.split]
        self.data = self.load_data(self.processed_paths[idx])

    @property
    def raw_file_names(self):
        splits = ["train", "valid", "test"]
        files = ["feats.npy", "graph_id.npy", "graph.json", "labels.npy"]
        return [f"{s}_{f}" for s in splits for f in files]

    @property
    def processed_file_names(self):
        return [f"{s}_torch.pkl" for s in ("train", "val", "test")]

    def download(self):
        path = download_url(self.url, self.raw_dir)
        extract_zip(path, self.raw_dir)
        os.unlink(path)

    def process(self):
        for s, split in enumerate(["train", "valid", "test"]):
            with open(osp.join(self.raw_dir, f"{split}_graph.json")) as f:
                gj = json.load(f)
            edges = np.asarray([(l["source"], l["target"])
                                for l in gj["links"]], dtype=np.int64).T
            x = np.load(osp.join(self.raw_dir, f"{split}_feats.npy"))
            y = np.load(osp.join(self.raw_dir, f"{split}_labels.npy"))
            gid = np.load(osp.join(
                self.raw_dir, f"{split}_graph_id.npy")).astype(np.int64)
            gid = gid - gid.min()
            graphs = []
            edge_gid = gid[edges[0]]
            node_ptr = np.concatenate(
                [[0], np.cumsum(np.bincount(gid))])
            for i in range(int(gid.max()) + 1):
                emask = edge_gid == i
                ei = edges[:, emask] - node_ptr[i]
                ei, _ = remove_self_loops(ei)
                nmask = gid == i
                graphs.append(Graph(edge_index=ei,
                                    x=x[nmask].astype(np.float32),
                                    y=y[nmask].astype(np.float32)))
            if self.pre_filter is not None:
                graphs = [g for g in graphs if self.pre_filter(g)]
            if self.pre_transform is not None:
                graphs = [self.pre_transform(g) for g in graphs]
            self.save_data(self.collate(graphs), self.processed_paths[s])

