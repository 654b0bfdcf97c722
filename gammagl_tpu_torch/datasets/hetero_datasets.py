"""Heterogeneous benchmark datasets: IMDB, DBLP, HGBDataset (counterpart
of `gammagl_tpu/datasets/hetero_datasets.py`; reference:
gammagl/datasets/{imdb,dblp,hgb}.py).

IMDB and DBLP read the processed-zip layout: per-type CSR feature files,
a label npy, a split npz and the block adjacency ``adjM.npz``, from which
each ordered pair of node types with edges between them becomes a
relation ``(src, "to", dst)``. HGBDataset reads the HGB text files. Each
writes its processed cache under the port's own name (``data_torch.pkl``).
"""

import os
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data import (HeteroGraph, InMemoryDataset,
                                    download_url, extract_zip)

__all__ = ["IMDB", "DBLP", "HGBDataset"]


def _masks_from_split(store, split, num_nodes):
    for name in ("train", "val", "test"):
        idx = split[f"{name}_idx"]
        mask = np.zeros(num_nodes, dtype=bool)
        mask[idx] = True
        store[f"{name}_mask"] = mask


class IMDB(InMemoryDataset):
    """movie / director / actor typed graph (reference imdb.py)."""

    url = "https://www.dropbox.com/s/g0btk9ctr1es39x/IMDB_processed.zip?dl=1"
    node_types = ["movie", "director", "actor"]
    target = "movie"

    @property
    def raw_file_names(self):
        return ["adjM.npz", "features_0.npz", "features_1.npz",
                "features_2.npz", "labels.npy", "train_val_test_idx.npz"]

    def download(self):
        path = download_url(self.url, self.raw_dir, filename="data.zip")
        extract_zip(path, self.raw_dir)
        os.remove(path)

    def process(self):
        import scipy.sparse as sp

        data = HeteroGraph()
        for i, nt in enumerate(self.node_types):
            x = sp.load_npz(osp.join(self.raw_dir, f"features_{i}.npz"))
            data[nt].x = np.asarray(x.todense(), np.float32)
        y = np.load(osp.join(self.raw_dir, "labels.npy"))
        data[self.target].y = y.astype(np.int64)
        split = np.load(osp.join(self.raw_dir, "train_val_test_idx.npz"))
        _masks_from_split(data[self.target], split,
                          data[self.target].num_nodes)

        # typed edges from the block adjacency (global id space)
        sizes = [data[nt].num_nodes for nt in self.node_types]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        adj = sp.load_npz(osp.join(self.raw_dir, "adjM.npz")).tocoo()
        row, col = adj.row, adj.col
        for i, src_t in enumerate(self.node_types):
            for j, dst_t in enumerate(self.node_types):
                if i == j:
                    continue
                mask = ((row >= offsets[i]) & (row < offsets[i + 1])
                        & (col >= offsets[j]) & (col < offsets[j + 1]))
                if not mask.any():
                    continue
                data[(src_t, "to", dst_t)].edge_index = np.stack(
                    [row[mask] - offsets[i], col[mask] - offsets[j]]
                ).astype(np.int64)
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = data
        self.save_data(data, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class DBLP(IMDB):
    """author / paper / term / conference graph (reference dblp.py)."""

    url = "https://www.dropbox.com/s/yh4grpeks87ugr2/DBLP_processed.zip?dl=1"
    node_types = ["author", "paper", "term", "conference"]
    target = "author"

    @property
    def raw_file_names(self):
        return ["adjM.npz", "features_0.npz", "features_1.npz",
                "features_2.npz", "labels.npy", "train_val_test_idx.npz"]

    def process(self):
        import scipy.sparse as sp

        data = HeteroGraph()
        for i, nt in enumerate(self.node_types[:3]):
            x = sp.load_npz(osp.join(self.raw_dir, f"features_{i}.npz"))
            data[nt].x = np.asarray(x.todense(), np.float32)
        # conference nodes carry no features in the release
        y = np.load(osp.join(self.raw_dir, "labels.npy"))
        data[self.target].y = y.astype(np.int64)
        split = np.load(osp.join(self.raw_dir, "train_val_test_idx.npz"))
        _masks_from_split(data[self.target], split,
                          data[self.target].num_nodes)
        sizes = [data[nt].num_nodes or 0 for nt in self.node_types[:3]]
        adj = sp.load_npz(osp.join(self.raw_dir, "adjM.npz")).tocoo()
        n_conf = adj.shape[0] - sum(sizes)
        data["conference"].num_nodes = n_conf
        sizes.append(n_conf)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        row, col = adj.row, adj.col
        for i, src_t in enumerate(self.node_types):
            for j, dst_t in enumerate(self.node_types):
                if i == j:
                    continue
                mask = ((row >= offsets[i]) & (row < offsets[i + 1])
                        & (col >= offsets[j]) & (col < offsets[j + 1]))
                if not mask.any():
                    continue
                data[(src_t, "to", dst_t)].edge_index = np.stack(
                    [row[mask] - offsets[i], col[mask] - offsets[j]]
                ).astype(np.int64)
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = data
        self.save_data(data, self.processed_paths[0])


class HGBDataset(InMemoryDataset):
    """Heterogeneous Graph Benchmark collections (ACM/DBLP/Freebase/IMDB),
    reference hgb.py. Raw format: node.dat / link.dat / label.dat text files
    with typed ids."""

    url = "https://cloud.tsinghua.edu.cn/d/2d965d2fc2ee41d09def/files/?p="
    names = {"acm": "ACM", "dblp": "DBLP", "freebase": "Freebase",
             "imdb": "IMDB"}

    def __init__(self, root=None, name="acm", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in self.names
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
        return ["node.dat", "link.dat", "label.dat", "label.dat.test",
                "info.dat"]

    def download(self):
        raise RuntimeError(
            "HGB raw files must be placed manually under "
            f"{self.raw_dir} (Tsinghua cloud download requires a browser)")

    def process(self):
        import json

        with open(osp.join(self.raw_dir, "info.dat")) as f:
            info = json.load(f)
        nt_names = {int(k): v[0] for k, v in
                    info["node.dat"]["node type"].items()} \
            if "node.dat" in info else {}
        data = HeteroGraph()
        # node.dat: id \t name \t type [\t features]
        type_of = {}
        local = {}
        feats = {}
        with open(osp.join(self.raw_dir, "node.dat")) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                nid, _, ntype = int(parts[0]), parts[1], int(parts[2])
                nt = nt_names.get(ntype, str(ntype))
                type_of[nid] = nt
                local.setdefault(nt, {})
                local[nt][nid] = len(local[nt])
                if len(parts) > 3 and parts[3]:
                    feats.setdefault(nt, []).append(
                        [float(v) for v in parts[3].split(",")])
        for nt, mapping in local.items():
            data[nt].num_nodes = len(mapping)
            if nt in feats and len(feats[nt]) == len(mapping):
                data[nt].x = np.asarray(feats[nt], np.float32)
        # link.dat: src \t dst \t type \t weight
        lt_names = {int(k): v for k, v in
                    info.get("link.dat", {}).get("link type", {}).items()}
        edges = {}
        with open(osp.join(self.raw_dir, "link.dat")) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                s, d, lt = int(parts[0]), int(parts[1]), int(parts[2])
                st, dt = type_of[s], type_of[d]
                rel = (lt_names.get(lt, {}).get("meaning", str(lt))
                       if isinstance(lt_names.get(lt), dict) else str(lt))
                key = (st, rel, dt)
                edges.setdefault(key, [[], []])
                edges[key][0].append(local[st][s])
                edges[key][1].append(local[dt][d])
        for key, (rows, cols) in edges.items():
            data[key].edge_index = np.asarray([rows, cols], np.int64)
        # label.dat: id \t name \t type \t label
        for fname, mask_name in (("label.dat", "train_mask"),
                                 ("label.dat.test", "test_mask")):
            path = osp.join(self.raw_dir, fname)
            if not osp.exists(path):
                continue
            with open(path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 4:
                        continue
                    nid, label = int(parts[0]), parts[3]
                    nt = type_of[nid]
                    store = data[nt]
                    n = store.num_nodes
                    if "y" not in store:
                        store.y = np.full(n, -1, np.int64)
                        store.train_mask = np.zeros(n, bool)
                        store.test_mask = np.zeros(n, bool)
                    lid = local[nt][nid]
                    store.y[lid] = int(label.split(",")[0])
                    store[mask_name][lid] = True
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = data
        self.save_data(data, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data
