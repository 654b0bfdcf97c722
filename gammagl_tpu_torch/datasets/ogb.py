"""OGB node-property datasets (ogbn-arxiv, ogbn-products,
ogbn-papers100M) read from OGB's directory layout, staged beforehand
(counterpart of `gammagl_tpu/datasets/ogb.py`). There is no download.

Three raw layouts under ``<root>/<name with _>/raw/``:

1. **npy**: ``node_feat.npy``, ``edge_index.npy``, ``node_label.npy``,
   opened with ``mmap_mode='r'``, so a papers100M-scale graph costs no
   resident host memory until it is sliced (`utils.to_device` and
   `parallel.shard_nodes` copy only the rows they send to the card);
2. **npz** (OGB's large-graph format): ``data.npz`` with ``node_feat`` /
   ``edge_index`` members, and ``node-label.npz``;
3. **csv.gz** (OGB's small-graph format, e.g. ogbn-arxiv):
   ``node-feat.csv.gz``, ``edge.csv.gz``, ``node-label.csv.gz``,
   converted once to the npy layout.

Split indices come from ``<root>/<name with _>/split/<split_type>/
{train,valid,test}.csv.gz`` (or ``.npy``); ``split_type`` defaults to the
dataset's official split (time, sales_ranking). The processed marker is
``meta.json``, the JAX package's own: it holds no objects, so both
packages share it.
"""

import gzip
import json
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data.dataset import Dataset
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.mask import index_to_mask

__all__ = ["OgbNodeDataset"]

_OFFICIAL_SPLIT = {
    "ogbn-arxiv": "time",
    "ogbn-papers100M": "time",
    "ogbn-products": "sales_ranking",
    "ogbn-mag": "time",
    "ogbn-proteins": "species",
}


def _read_csv_gz(path, dtype):
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


class OgbNodeDataset(Dataset):
    """One-graph node-property dataset in OGB's on-disk layout."""

    def __init__(self, root=None, name="ogbn-arxiv", split_type=None,
                 transform=None, to_undirected=False, force_reload=False):
        self.name = name
        self.dir_name = name.replace("-", "_")
        self.split_type = split_type or _OFFICIAL_SPLIT.get(name, "time")
        self.to_undirected = to_undirected
        self._graph = None
        super().__init__(root, transform, force_reload=force_reload)

    # -- paths ---------------------------------------------------------------
    @property
    def raw_dir(self):
        return osp.join(self.root, self.dir_name, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, self.dir_name, "processed")

    @property
    def split_dir(self):
        return osp.join(self.root, self.dir_name, "split", self.split_type)

    def _layout(self):
        """Which staged layout is present: 'npy' | 'npz' | 'csv' | None."""
        for layout, name in (("npy", "node_feat.npy"), ("npz", "data.npz"),
                             ("csv", "node-feat.csv.gz")):
            if osp.exists(osp.join(self.raw_dir, name)):
                return layout
        return None

    @property
    def raw_file_names(self):
        layout = self._layout()
        if layout == "npy":
            return ["node_feat.npy", "edge_index.npy"]
        if layout == "npz":
            return ["data.npz"]
        return ["node-feat.csv.gz", "edge.csv.gz", "node-label.csv.gz"]

    @property
    def processed_file_names(self):
        return "meta.json"

    def download(self):
        raise RuntimeError(
            f"{self.name} is not staged under {self.raw_dir}, and OGB "
            "archives are not downloaded: stage OGB's layout (raw/ and "
            "split/) or the npy files (node_feat.npy, edge_index.npy, "
            "node_label.npy).")

    # -- processing ----------------------------------------------------------
    def process(self):
        """A csv.gz layout is converted once to npy; npy and npz are used
        in place. Only the meta marker is written: the graph itself is
        never pickled."""
        if self._layout() == "csv":
            raw = self.raw_dir
            np.save(osp.join(raw, "node_feat.npy"), _read_csv_gz(
                osp.join(raw, "node-feat.csv.gz"), np.float32))
            np.save(osp.join(raw, "edge_index.npy"), np.ascontiguousarray(
                _read_csv_gz(osp.join(raw, "edge.csv.gz"), np.int64).T))
            lbl = osp.join(raw, "node-label.csv.gz")
            if osp.exists(lbl):
                np.save(osp.join(raw, "node_label.npy"),
                        _read_csv_gz(lbl, np.float64).ravel())
        with open(self.processed_paths[0], "w") as f:
            json.dump({"name": self.name, "layout": self._layout()}, f)

    # -- access --------------------------------------------------------------
    def _load_graph(self):
        y = None
        if self._layout() == "npz":
            d = np.load(osp.join(self.raw_dir, "data.npz"))
            x = d[[k for k in d.files if "feat" in k][0]]
            ei = d[[k for k in d.files if "edge" in k and "index" in k][0]]
            lblf = osp.join(self.raw_dir, "node-label.npz")
            if osp.exists(lblf):
                lbl = np.load(lblf)
                y = lbl[lbl.files[0]].ravel()
        else:
            x = np.load(osp.join(self.raw_dir, "node_feat.npy"),
                        mmap_mode="r")
            ei = np.load(osp.join(self.raw_dir, "edge_index.npy"),
                         mmap_mode="r")
            lblf = osp.join(self.raw_dir, "node_label.npy")
            if osp.exists(lblf):
                y = np.load(lblf, mmap_mode="r")
        if ei.shape[0] != 2:
            ei = ei.T
        if self.to_undirected:
            ei = np.concatenate([np.asarray(ei), np.asarray(ei)[::-1]],
                                axis=1)
        g = Graph(x=x, edge_index=ei)
        n = x.shape[0]
        if y is not None:
            yy = np.asarray(y)
            g.y = np.where(np.isnan(yy), -1, yy).astype(np.int64)
        for split, attr in (("train", "train_idx"), ("valid", "val_idx"),
                            ("test", "test_idx")):
            idx = self._split_idx(split)
            if idx is not None:
                g[attr] = idx
                g[attr.replace("idx", "mask")] = index_to_mask(idx, n)
        return g

    def _split_idx(self, split):
        npy = osp.join(self.split_dir, f"{split}.npy")
        if osp.exists(npy):
            return np.load(npy)
        csv = osp.join(self.split_dir, f"{split}.csv.gz")
        if osp.exists(csv):
            return _read_csv_gz(csv, np.int64).ravel()
        return None

    def len(self):
        return 1

    def get(self, idx):
        assert idx == 0
        if self._graph is None:
            self._graph = self._load_graph()
        return self._graph

    @property
    def num_classes(self):
        g = self[0]
        return int(np.asarray(g.y).max()) + 1 if "y" in g else 0
