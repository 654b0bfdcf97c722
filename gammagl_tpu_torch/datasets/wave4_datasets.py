"""Datasets wave 4: ModelNet40, ShapeNet, NGSIM, ACM4DHN, ACM4Rohe,
ADDataset, AliRCD.

Counterpart of `gammagl_tpu/datasets/wave4_datasets.py` (reference:
gammagl/datasets/{modelnet40,shapenet,ngsim,acm4dhn,acm4rohe,ADDataset,
alircd}.py). Host-side numpy; graphs come out as the port's `Graph` and
`HeteroGraph`. The point-cloud datasets (ModelNet40, ShapeNet) store
fixed-size point sets. ACM4Rohe's split is a seeded numpy draw, the JAX
package's stream. The processed caches are the port's own (``*_torch.pkl``;
NGSIM reads its extracted per-sample files directly).
"""

import glob
import json
import os
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data import (Graph, HeteroGraph, InMemoryDataset,
                              download_url, extract_zip)

__all__ = ["ModelNet40", "ShapeNet", "NGSIM_US_101", "ACM4DHN", "ACM4Rohe",
           "ADDataset", "AliRCD"]


class ModelNet40(InMemoryDataset):
    """12,311 CAD point clouds over 40 classes (reference modelnet40.py:12;
    DGCNN benchmark). Each item: `x` = (num_points, 3) float32, `y` = class.
    """

    url = ("https://shapenet.cs.stanford.edu/media/"
           "modelnet40_ply_hdf5_2048.zip")

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, split="train", num_points=1024,
                 force_reload=False):
        assert split in ("train", "test")
        self.num_points = num_points
        self.split = split
        super().__init__(root, transform, pre_transform, pre_filter,
                         force_reload)
        path = self.processed_paths[0] if split == "train" \
            else self.processed_paths[1]
        self.data = self.load_data(path)

    @property
    def raw_file_names(self):
        return ["ply_data_train0.h5", "ply_data_test0.h5"]

    @property
    def processed_file_names(self):
        return ["train_data_torch.pkl", "test_data_torch.pkl"]

    def download(self):
        path = download_url(self.url, self.root)
        extract_zip(path, self.root)
        name = self.url.split("/")[-1].split(".")[0]
        extracted = osp.join(self.root, name)
        if osp.exists(extracted):
            if osp.exists(self.raw_dir):
                import shutil
                shutil.rmtree(self.raw_dir)
            os.rename(extracted, self.raw_dir)

    def process(self):
        import h5py
        for i, split in enumerate(("train", "test")):
            data_list = []
            for h5_name in sorted(glob.glob(
                    osp.join(self.raw_dir, f"ply_data_{split}*.h5"))):
                with h5py.File(h5_name, "r") as f:
                    x = f["data"][:].astype(np.float32)
                    y = f["label"][:].astype(np.int64)
                for j in range(x.shape[0]):
                    data_list.append(Graph(x=x[j][:self.num_points],
                                           y=int(y[j][0]),
                                           num_nodes=self.num_points))
            if self.pre_filter is not None:
                data_list = [d for d in data_list if self.pre_filter(d)]
            if self.pre_transform is not None:
                data_list = [self.pre_transform(d) for d in data_list]
            self.save_data(self.collate(data_list), self.processed_paths[i])


class ShapeNet(InMemoryDataset):
    """ShapeNet part segmentation (reference shapenet.py:17): 16 categories,
    per-point part labels. Items: `pos` (N,3), `x` normals (N,3), `y` part
    label per point, `category` id."""

    url = ("https://shapenet.cs.stanford.edu/media/"
           "shapenetcore_partanno_segmentation_benchmark_v0_normal.zip")

    category_ids = {
        "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340",
        "Car": "02958343", "Chair": "03001627", "Earphone": "03261776",
        "Guitar": "03467517", "Knife": "03624134", "Lamp": "03636649",
        "Laptop": "03642806", "Motorbike": "03790512", "Mug": "03797390",
        "Pistol": "03948459", "Rocket": "04099429", "Skateboard": "04225987",
        "Table": "04379243",
    }
    seg_classes = {
        "Airplane": [0, 1, 2, 3], "Bag": [4, 5], "Cap": [6, 7],
        "Car": [8, 9, 10, 11], "Chair": [12, 13, 14, 15],
        "Earphone": [16, 17, 18], "Guitar": [19, 20, 21], "Knife": [22, 23],
        "Lamp": [24, 25, 26, 27], "Laptop": [28, 29],
        "Motorbike": [30, 31, 32, 33, 34, 35], "Mug": [36, 37],
        "Pistol": [38, 39, 40], "Rocket": [41, 42, 43],
        "Skateboard": [44, 45, 46], "Table": [47, 48, 49],
    }

    def __init__(self, root=None, categories=None, include_normals=True,
                 split="trainval", transform=None, pre_transform=None,
                 pre_filter=None, force_reload=False):
        if categories is None:
            categories = list(self.category_ids.keys())
        if isinstance(categories, str):
            categories = [categories]
        assert all(c in self.category_ids for c in categories)
        self.categories = categories
        self.include_normals = include_normals
        super().__init__(root, transform, pre_transform, pre_filter,
                         force_reload)
        idx = {"train": 0, "val": 1, "test": 2, "trainval": 3}[split]
        self.data = self.load_data(self.processed_paths[idx])

    @property
    def raw_file_names(self):
        return list(self.category_ids.values()) + ["train_test_split"]

    @property
    def processed_file_names(self):
        cats = "_".join(c[:3].lower() for c in sorted(self.categories))
        return [f"{cats}_{s}_torch.pkl" for s in ("train", "val", "test",
                                            "trainval")]

    def download(self):
        path = download_url(self.url, self.root)
        extract_zip(path, self.root)
        os.unlink(path)
        name = self.url.split("/")[-1].split(".")[0]
        extracted = osp.join(self.root, name)
        if osp.exists(extracted):
            import shutil
            if osp.exists(self.raw_dir):
                shutil.rmtree(self.raw_dir)
            os.rename(extracted, self.raw_dir)

    def _process_filenames(self, filenames):
        ids = [self.category_ids[c] for c in self.categories]
        cat_idx = {cid: i for i, cid in enumerate(ids)}
        data_list = []
        for name in filenames:
            cat = name.split(osp.sep)[0]
            if cat not in cat_idx:
                continue
            raw = np.loadtxt(osp.join(self.raw_dir, name), dtype=np.float32)
            raw = np.atleast_2d(raw)
            g = Graph(pos=raw[:, :3], y=raw[:, -1].astype(np.int64),
                      category=cat_idx[cat], num_nodes=raw.shape[0])
            if self.include_normals:
                g.x = raw[:, 3:6]
            if self.pre_filter is not None and not self.pre_filter(g):
                continue
            if self.pre_transform is not None:
                g = self.pre_transform(g)
            data_list.append(g)
        return data_list

    def process(self):
        trainval = []
        for i, split in enumerate(("train", "val", "test")):
            path = osp.join(self.raw_dir, "train_test_split",
                            f"shuffled_{split}_file_list.json")
            with open(path) as f:
                filenames = [osp.sep.join(n.split("/")[1:]) + ".txt"
                             for n in json.load(f)]
            data_list = self._process_filenames(filenames)
            if split in ("train", "val"):
                trainval += data_list
            self.save_data(self.collate(data_list), self.processed_paths[i])
        self.save_data(self.collate(trainval), self.processed_paths[3])


class NGSIM_US_101(InMemoryDataset):
    """NGSIM US-101 vehicle-trajectory interaction graphs (reference
    ngsim.py:10): per-sample pickled graphs with `x` trajectory histories,
    `edge_attr`/`edge_type` matrices — consumed by the HEAT model."""

    url = "https://github.com/gjy1221/NGSIM-US-101/raw/main/data"

    def __init__(self, root=None, name="train", transform=None,
                 pre_transform=None, force_reload=False):
        self.split = name.lower()
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)
        self.data_path = osp.join(self.processed_dir, self.split)
        self.data_names = sorted(os.listdir(self.data_path)) \
            if osp.isdir(self.data_path) else []

    @property
    def raw_dir(self):
        return osp.join(self.root, "ngsim", "raw", self.split)

    @property
    def processed_dir(self):
        return osp.join(self.root, "ngsim", "processed")

    @property
    def raw_file_names(self):
        return [f"{self.split}.zip"]

    @property
    def processed_file_names(self):
        return [self.split]  # a directory of per-sample files

    def download(self):
        path = download_url(f"{self.url}/{self.raw_file_names[0]}",
                            self.raw_dir)
        extract_zip(path, self.processed_dir)

    def process(self):
        pass  # extraction in download() already populates processed_dir

    def load_data(self, path):
        return None  # per-sample files are read lazily in get()

    def len(self):
        return len(self.data_names)

    def get(self, idx):
        import pickle
        with open(osp.join(self.data_path, self.data_names[idx]),
                  "rb") as f:
            item = pickle.load(f)
        if isinstance(item, dict):
            g = Graph()
            for k, v in item.items():
                g[k] = v
            item = g
        if hasattr(item, "edge_attr") and \
                getattr(item, "edge_attr", None) is not None:
            item.edge_attr = np.swapaxes(np.asarray(item.edge_attr), 0, 1)
        if hasattr(item, "edge_type") and \
                getattr(item, "edge_type", None) is not None:
            item.edge_type = np.swapaxes(np.asarray(item.edge_type), 0, 1)
        return item


class ACM4DHN(InMemoryDataset):
    """Movie-actor bipartite edges for DHN link prediction (reference
    acm4dhn.py:7): parses `MA.txt` ('M123 A45' lines; actor ids stored as
    -id-1 like the reference), chronological train/val/test edge split."""

    url = "https://raw.githubusercontent.com/BUPT-GAMMA/HDE/main/ds/imdb"

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, force_reload=False, test_ratio=0.3):
        self.test_ratio = test_ratio
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)
        self.data = self.load_data(self.processed_paths[0])

    @property
    def raw_file_names(self):
        return ["MA.txt"]

    def download(self):
        download_url(f"{self.url}/MA.txt", self.raw_dir)

    def process(self):
        ms, as_ = [], []
        with open(osp.join(self.raw_dir, "MA.txt")) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) != 2:
                    continue
                for tok in parts:
                    if tok[0] == "M":
                        ms.append(int(tok[1:]))
                    elif tok[0] == "A":
                        as_.append(-int(tok[1:]) - 1)
        g = HeteroGraph()
        edge_index = np.array([ms, as_], np.int64)
        g[("M", "MA", "A")].edge_index = edge_index

        e = edge_index.shape[1]
        sp1 = int(e * (1 - 2 * self.test_ratio))
        sp2 = int(e * self.test_ratio)
        for name, sl in (("train", slice(0, sp1)),
                         ("val", slice(sp1, sp1 + sp2)),
                         ("test", slice(sp1 + sp2, e))):
            sub = HeteroGraph()
            sub[("M", "MA", "A")].edge_index = edge_index[:, sl]
            g[name] = sub
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = g
        self.save_data(g, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class ACM4Rohe(InMemoryDataset):
    """ACM hetero graph prepared for RoheHAN robustness experiments
    (reference acm4rohe.py): ACM.mat -> paper/author/field nodes, pa/pf
    edges, conference-derived 3-class labels, random 20/10/70 split."""

    url = "https://github.com/Jhy1993/HAN/raw/master/data/acm/ACM.mat"

    def __init__(self, root=None, transform=None, pre_transform=None,
                 force_reload=False, seed=0):
        self.seed = seed
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)
        self.data = self.load_data(self.processed_paths[0])

    @property
    def raw_file_names(self):
        return ["ACM.mat"]

    def download(self):
        download_url(self.url, self.raw_dir)

    def process(self):
        from scipy import io as sio
        import scipy.sparse as sp
        data = sio.loadmat(osp.join(self.raw_dir, "ACM.mat"))
        p_vs_f = data["PvsL"]
        p_vs_a = data["PvsA"]
        p_vs_t = data["PvsT"]
        p_vs_c = data["PvsC"]

        conf_ids = [0, 1, 9, 10, 13]
        label_ids = [0, 1, 2, 2, 1]
        p_selected = np.nonzero(np.asarray(
            p_vs_c[:, conf_ids].sum(1)).ravel())[0]
        p_vs_f = p_vs_f[p_selected]
        p_vs_a = p_vs_a[p_selected]
        p_vs_t = p_vs_t[p_selected]
        p_vs_c = p_vs_c[p_selected]

        labels = np.zeros(p_vs_c.shape[0], np.int64)
        for conf_id, label_id in zip(conf_ids, label_ids):
            idx = (p_vs_c[:, conf_id].toarray().ravel() > 0
                   if sp.issparse(p_vs_c)
                   else np.asarray(p_vs_c[:, conf_id]) > 0)
            labels[np.nonzero(idx)[0]] = label_id

        rng = np.random.default_rng(self.seed)
        float_mask = np.zeros(p_vs_c.shape[0], np.float32)
        for conf_id in conf_ids:
            mask = (p_vs_c[:, conf_id].toarray().ravel() > 0
                    if sp.issparse(p_vs_c)
                    else np.asarray(p_vs_c[:, conf_id]) > 0)
            float_mask[mask] = rng.uniform(0, 1, mask.sum())

        n = p_vs_t.shape[0]
        g = HeteroGraph()
        g["paper"].x = np.asarray(p_vs_t.todense(), np.float32)
        g["paper"].y = labels
        g["paper"].num_nodes = n
        g["author"].num_nodes = p_vs_a.shape[1]
        g["field"].num_nodes = p_vs_f.shape[1]
        pa = np.vstack(p_vs_a.nonzero()).astype(np.int64)
        pf = np.vstack(p_vs_f.nonzero()).astype(np.int64)
        g[("paper", "pa", "author")].edge_index = pa
        g[("author", "ap", "paper")].edge_index = pa[::-1].copy()
        g[("paper", "pf", "field")].edge_index = pf
        g[("field", "fp", "paper")].edge_index = pf[::-1].copy()
        g["paper"].train_mask = float_mask <= 0.2
        g["paper"].val_mask = (float_mask > 0.2) & (float_mask <= 0.3)
        g["paper"].test_mask = float_mask > 0.3
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = g
        self.save_data(g, self.processed_paths[0])

    @staticmethod
    def get_meta_graph(adj_dict, features, labels=None, train_mask=None,
                       val_mask=None, test_mask=None):
        """PAP / PFP metapath graph (reference acm4rohe.py:177-199)."""
        mg = HeteroGraph()
        mg["paper"].x = features
        mg["paper"].num_nodes = features.shape[0]
        mg[("paper", "author", "paper")].edge_index = np.asarray(
            (adj_dict["pa"].dot(adj_dict["ap"])).nonzero(), dtype=np.int64)
        mg[("paper", "field", "paper")].edge_index = np.asarray(
            (adj_dict["pf"].dot(adj_dict["fp"])).nonzero(), dtype=np.int64)
        mg["paper"].y = labels
        mg["paper"].train_mask = train_mask
        mg["paper"].val_mask = val_mask
        mg["paper"].test_mask = test_mask
        return mg

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class ADDataset(InMemoryDataset):
    """Anomaly-detection graphs with injected outliers (reference
    ADDataset.py:14): one npz per variant (inj_cora, books, ...) with
    edge_index / x / y."""

    url = "https://github.com/SharkRemW/data/raw/main/processed"

    def __init__(self, root=None, name="inj_cora", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)
        self.data = self.load_data(self.processed_paths[0])

    @property
    def raw_dir(self):
        return osp.join(self.root, self.name, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, self.name, "processed")

    @property
    def raw_file_names(self):
        return [f"{self.name}.npz"]

    def download(self):
        download_url(f"{self.url}/{self.name}.npz", self.raw_dir)

    def process(self):
        data = np.load(osp.join(self.raw_dir, f"{self.name}.npz"),
                       allow_pickle=True)
        g = Graph(edge_index=data["edge_index"].astype(np.int64),
                  x=data["x"].astype(np.float32),
                  y=data["y"].astype(np.int64))
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.save_data(self.collate([g]), self.processed_paths[0])


class AliRCD(InMemoryDataset):
    """Alibaba risk-commodity detection hetero graph (reference
    alircd.py:12): ICDM'22 contest data — typed nodes with 256-d embeddings,
    typed edges, binary item labels. The reference streams two multi-GB
    CSVs; this implementation does the same parse with numpy batching."""

    url = ("https://s3.cn-north-1.amazonaws.com.cn/dgl-data/dataset/"
           "openhgnn/AliRCD_session1.zip")

    def __init__(self, root=None, transform=None, pre_transform=None,
                 force_reload=False):
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)
        self.data = self.load_data(self.processed_paths[0])

    @property
    def raw_file_names(self):
        return ["AliRCD_session1_edges.csv", "AliRCD_session1_nodes.csv",
                "AliRCD_session1_train_labels.csv"]

    def download(self):
        path = download_url(self.url, self.raw_dir)
        extract_zip(path, self.raw_dir)
        os.unlink(path)

    def process(self):
        node_file, edge_file, label_file = (
            osp.join(self.raw_dir, self.raw_file_names[1]),
            osp.join(self.raw_dir, self.raw_file_names[0]),
            osp.join(self.raw_dir, self.raw_file_names[2]))
        # node id -> (type, local id); 256-d embedding per node
        node_maps = {}
        node_embeds = {}
        with open(node_file) as rf:
            for line in rf:
                info = line.strip().split(",")
                if len(info) < 2:
                    continue
                node_id, node_type = int(info[0]), info[1].strip()
                local = node_maps.setdefault(node_type, {})
                lid = local.setdefault(node_id, len(local))
                embeds = node_embeds.setdefault(node_type, [])
                if len(info) > 2 and len(info[2]) >= 50:
                    embeds.append(np.fromstring(info[2], np.float32,
                                                sep=":"))
                else:
                    embeds.append(np.zeros(256, np.float32))

        g = HeteroGraph()
        for t, local in node_maps.items():
            g[t].x = np.stack(node_embeds[t])
            g[t].num_nodes = len(local)

        edges = {}
        with open(edge_file) as rf:
            for line in rf:
                info = line.strip().split(",")
                if len(info) < 5:
                    continue
                src, dst = int(info[0]), int(info[1])
                st, dt, rel = info[2].strip(), info[3].strip(), \
                    info[4].strip()
                if st not in node_maps or dt not in node_maps:
                    continue
                edges.setdefault((st, rel, dt), ([], []))
                edges[(st, rel, dt)][0].append(node_maps[st][src])
                edges[(st, rel, dt)][1].append(node_maps[dt][dst])
        for key, (s, d) in edges.items():
            g[key].edge_index = np.array([s, d], np.int64)

        labels = np.full(g["item"].num_nodes, -1, np.int64) \
            if "item" in node_maps else None
        if labels is not None and osp.exists(label_file):
            with open(label_file) as rf:
                for line in rf:
                    info = line.strip().split(",")
                    if len(info) == 2 and int(info[0]) in node_maps["item"]:
                        labels[node_maps["item"][int(info[0])]] = int(
                            info[1])
            g["item"].y = labels
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = g
        self.save_data(g, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data
