"""Assorted datasets: PolBlogs, BlogCatalog, CA-GrQc, Airports, Entities
(RGCN knowledge graphs), ZINC (counterpart of
`gammagl_tpu/datasets/misc_datasets.py`; reference:
gammagl/datasets/{polblogs,blogcatalog,ca_grqc,airports,entities,zinc}.py).

Entities parses its N-Triples with rdflib when rdflib imports and with a
minimal parser otherwise, in that order, as the JAX package does, so both
packages read a file the same way on any machine. Each dataset writes its
processed cache under the port's own name (``data_torch.pkl``; ZINC's
splits ``<split>_torch.pkl``).
"""

import os
import os.path as osp
import pickle

import numpy as np

from gammagl_tpu_torch.data import (InMemoryDataset, download_url,
                                    extract_gz, extract_tar, extract_zip)
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.undirected import to_undirected

__all__ = ["PolBlogs", "BlogCatalog", "CAGrQc", "Airports", "Entities",
           "ZINC"]


class PolBlogs(InMemoryDataset):
    """Political blogs (reference polblogs.py)."""

    url = "https://netset.telecom-paris.fr/datasets/polblogs.tar.gz"

    @property
    def raw_file_names(self):
        return ["adjacency.tsv", "labels.tsv"]

    def download(self):
        path = download_url(self.url, self.raw_dir)
        extract_tar(path, self.raw_dir, mode="r:gz")
        os.remove(path)

    def process(self):
        ei = []
        with open(osp.join(self.raw_dir, "adjacency.tsv")) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    ei.append((int(parts[0]), int(parts[1])))
        edge_index = np.asarray(ei, np.int64).T
        y = []
        with open(osp.join(self.raw_dir, "labels.tsv")) as f:
            for line in f:
                line = line.strip()
                if line:
                    y.append(int(line))
        y = np.asarray(y, np.int64)
        g = Graph(edge_index=edge_index, y=y, num_nodes=len(y))
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])


class BlogCatalog(InMemoryDataset):
    """Social network with attribute pickle (reference blogcatalog.py)."""

    url = ("https://raw.githubusercontent.com/EdisonLeeeee/"
           "GraphData/master/datasets/blogcatalog")

    @property
    def raw_file_names(self):
        return ["blogcatalog.zip"]

    def download(self):
        download_url(f"{self.url}/{self.raw_file_names[0]}", self.raw_dir)

    def process(self):
        import scipy.sparse as sp
        extract_zip(self.raw_paths[0], self.raw_dir)
        base = osp.join(self.raw_dir, "blogcatalog")
        adj = sp.load_npz(osp.join(base, "adj.npz")).tocoo()
        x = np.load(osp.join(base, "attr.npz"), allow_pickle=True)
        g = Graph(edge_index=np.stack([adj.row, adj.col]).astype(np.int64),
                  x=np.asarray(x["arr_0"], np.float32)
                  if "arr_0" in getattr(x, "files", []) else None,
                  y=np.load(osp.join(base, "label.npy")).astype(np.int64))
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])


class CAGrQc(InMemoryDataset):
    """arXiv GR-QC collaboration network (reference ca_grqc.py)."""

    url = "https://snap.stanford.edu/data/ca-GrQc.txt.gz"

    @property
    def raw_file_names(self):
        return ["ca-GrQc.txt"]

    def download(self):
        path = download_url(self.url, self.raw_dir)
        extract_gz(path, self.raw_dir)

    def process(self):
        edges = []
        with open(self.raw_paths[0]) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                a, b = line.split()
                edges.append((int(a), int(b)))
        ei = np.asarray(edges, np.int64).T
        _, inv = np.unique(ei, return_inverse=True)
        ei = inv.reshape(ei.shape)
        g = Graph(edge_index=to_undirected(ei))
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])


class Airports(InMemoryDataset):
    """struc2vec airports graphs: usa / brazil / europe
    (reference airports.py)."""

    edge_url = ("https://raw.githubusercontent.com/leoribeiro/struc2vec/"
                "master/graph/{}-airports.edgelist")
    label_url = ("https://raw.githubusercontent.com/leoribeiro/struc2vec/"
                 "master/graph/labels-{}-airports.txt")

    def __init__(self, root=None, name="usa", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in ("usa", "brazil", "europe")
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
        return [f"{self.name}-airports.edgelist",
                f"labels-{self.name}-airports.txt"]

    def download(self):
        download_url(self.edge_url.format(self.name), self.raw_dir)
        download_url(self.label_url.format(self.name), self.raw_dir)

    def process(self):
        labels, index_map = [], {}
        with open(self.raw_paths[1]) as f:
            for i, line in enumerate(f.read().split("\n")[1:]):
                if not line.strip():
                    continue
                node, label = line.split()
                index_map[int(node)] = i
                labels.append(int(label))
        y = np.asarray(labels, np.int64)
        edges = []
        with open(self.raw_paths[0]) as f:
            for line in f:
                if not line.strip():
                    continue
                a, b = line.split()
                edges.append((index_map[int(a)], index_map[int(b)]))
        ei = to_undirected(np.asarray(edges, np.int64).T,
                           num_nodes=len(y))
        # one-hot degree features (reference behavior)
        deg = np.bincount(ei[0], minlength=len(y))
        x = np.zeros((len(y), int(deg.max()) + 1), np.float32)
        x[np.arange(len(y)), deg] = 1
        g = Graph(x=x, edge_index=ei, y=y)
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])


class Entities(InMemoryDataset):
    """RGCN knowledge graphs: AIFB / MUTAG / BGS / AM (reference
    entities.py). Requires `rdflib` to parse the ntriples; processing raises
    a clear error when it is unavailable."""

    url = "https://data.dgl.ai/dataset/{}.tgz"

    def __init__(self, root=None, name="aifb", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in ("aifb", "mutag", "bgs", "am")
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
        return [f"{self.name}_stripped.nt.gz", "completeDataset.tsv",
                "trainingSet.tsv", "testSet.tsv"]

    def download(self):
        path = download_url(self.url.format(self.name), self.root)
        extract_tar(path, self.raw_dir, mode="r:gz")
        os.remove(path)

    @staticmethod
    def _parse_nt(fh):
        """Minimal N-Triples parser: `<s> <p> <o> .` / literal objects.

        Replaces the reference's rdflib dependency (entities.py) for the
        standard stripped.nt releases; rdflib, when installed, is used
        instead for full spec coverage.
        """
        triples = []
        for raw in fh:
            line = raw.decode() if isinstance(raw, bytes) else raw
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.rstrip(" .").split(None, 2)
            if len(parts) != 3:
                continue
            triples.append(tuple(p.strip() for p in parts))
        return triples

    def process(self):
        import gzip

        try:
            import rdflib
            graph = rdflib.Graph()
            with gzip.open(self.raw_paths[0], "rb") as f:
                graph.parse(file=f, format="nt")
            triples = list(graph)
        except ImportError:
            with gzip.open(self.raw_paths[0], "rt") as f:
                triples = self._parse_nt(f)
        relations = sorted({str(p) for _, p, _ in triples})
        nodes = sorted({str(s) for s, _, _ in triples}
                       | {str(o) for _, _, o in triples})
        n2i = {n: i for i, n in enumerate(nodes)}
        r2i = {r: i for i, r in enumerate(relations)}
        src, dst, etype = [], [], []
        for s, p, o in triples:
            src.append(n2i[str(s)])
            dst.append(n2i[str(o)])
            etype.append(r2i[str(p)])
        g = Graph(edge_index=np.asarray([src, dst], np.int64),
                  num_nodes=len(nodes))
        g.edge_type = np.asarray(etype, np.int64)
        g.num_relations = len(relations)
        # labeled entity splits (reference entities.py:131-170: per-task
        # node/label TSV columns; entity URIs map back into n2i)
        headers = {"am": ("label_cateogory", "proxy"),
                   "aifb": ("label_affiliation", "person"),
                   "mutag": ("label_mutagenic", "bond"),
                   "bgs": ("label_lithogenesis", "rock")}
        label_header, nodes_header = headers[self.name]
        lab2i = {}

        def read_split(path):
            idx, ys = [], []
            with open(path) as f:
                cols = f.readline().rstrip("\n").split("\t")
                li, ni = cols.index(label_header), cols.index(nodes_header)
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) <= max(li, ni):
                        continue
                    ent = f"<{parts[ni]}>"
                    key = ent if ent in n2i else parts[ni]
                    if key not in n2i:
                        continue
                    lab = lab2i.setdefault(parts[li], len(lab2i))
                    idx.append(n2i[key])
                    ys.append(lab)
            return np.asarray(idx, np.int64), np.asarray(ys, np.int64)

        train_path = osp.join(self.raw_dir, "trainingSet.tsv")
        test_path = osp.join(self.raw_dir, "testSet.tsv")
        if osp.exists(train_path):
            g.train_idx, g.train_y = read_split(train_path)
        if osp.exists(test_path):
            g.test_idx, g.test_y = read_split(test_path)
        self.data = g
        self.save_data(g, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class ZINC(InMemoryDataset):
    """ZINC molecular graphs (reference zinc.py; pickled index/graph dicts)."""

    url = "https://www.dropbox.com/s/feo9qle74kg48gy/molecules.zip?dl=1"

    def __init__(self, root=None, subset=False, split="train",
                 transform=None, pre_transform=None, force_reload=False):
        assert split in ("train", "val", "test")
        self.subset = subset
        self.split = split
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)
        idx = {"train": 0, "val": 1, "test": 2}[split]
        self.data = self.load_data(self.processed_paths[idx])

    @property
    def raw_file_names(self):
        return ["molecules/train.pickle", "molecules/val.pickle",
                "molecules/test.pickle"]

    @property
    def processed_file_names(self):
        return ["train_torch.pkl", "val_torch.pkl", "test_torch.pkl"]

    def download(self):
        path = download_url(self.url, self.raw_dir, filename="molecules.zip")
        extract_zip(path, self.raw_dir)
        os.remove(path)

    def process(self):
        for i, split in enumerate(("train", "val", "test")):
            with open(osp.join(self.raw_dir, "molecules",
                               f"{split}.pickle"), "rb") as f:
                mols = pickle.load(f)
            graphs = []
            for mol in mols:
                x = np.asarray(mol["atom_type"], np.int64).reshape(-1, 1)
                adj = np.asarray(mol["bond_type"])
                ei = np.stack(np.nonzero(adj)).astype(np.int64)
                ea = adj[ei[0], ei[1]].astype(np.int64)
                g = Graph(x=x, edge_index=ei, edge_attr=ea,
                          y=np.asarray([mol["logP_SA_cycle_normalized"]],
                                       np.float32))
                graphs.append(g)
            self.save_data(self.collate(graphs), self.processed_paths[i])
