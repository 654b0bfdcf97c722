"""Datasets wave 3: ACM4HeCo, Bail/Credit (fairness), AMiner, MoleculeNet,
MovieLens(ml), CustomDataset (counterpart of
`gammagl_tpu/datasets/wave3_datasets.py`; reference:
gammagl/datasets/{acm4heco,bail,credit,aminer,molecule_net,ml,
custom_datasets}.py).

MoleculeNet converts SMILES with `_from_smiles`, a copy of the JAX
package's of `utils/smiles.py` (rdkit-gated: a molecule that rdkit cannot read,
or a machine without rdkit, drops the row). Each dataset writes its processed cache
under the port's own name (``data_torch.pkl``).
"""

import os
import os.path as osp
import pickle
import tempfile

import numpy as np

from gammagl_tpu_torch.data import (Graph, HeteroGraph, InMemoryDataset,
                                    download_url, extract_zip)

__all__ = ["ACM4HeCo", "Bail", "Credit", "AMiner", "MoleculeNet",
           "MovieLens", "CustomDataset"]


_ATOM_FEATURES = ["atomic_num", "chirality", "degree", "formal_charge",
                 "num_hs", "num_radical_electrons", "hybridization",
                 "is_aromatic", "is_in_ring"]


def _from_smiles(smiles, with_hydrogen=False, kekulize=False):
    """A molecule's `Graph` from its SMILES (reference
    gammagl/utils/smiles.py): x the atoms' categorical codes
    (``_ATOM_FEATURES``), both directions of each bond with its type,
    stereo and conjugation codes. Needs rdkit: raises ImportError
    without it, ValueError on a string rdkit cannot parse."""
    try:
        from rdkit import Chem
    except ImportError as e:
        raise ImportError("from_smiles requires rdkit") from e
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        raise ValueError(f"could not parse SMILES {smiles!r}")
    if with_hydrogen:
        mol = Chem.AddHs(mol)
    if kekulize:
        Chem.Kekulize(mol)

    xs = []
    for atom in mol.GetAtoms():
        xs.append([
            atom.GetAtomicNum(),
            int(atom.GetChiralTag()),
            atom.GetTotalDegree(),
            atom.GetFormalCharge() + 5,
            atom.GetTotalNumHs(),
            atom.GetNumRadicalElectrons(),
            int(atom.GetHybridization()),
            int(atom.GetIsAromatic()),
            int(atom.IsInRing()),
        ])
    x = np.asarray(xs, np.int64)

    rows, cols, attrs = [], [], []
    for bond in mol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        attr = [int(bond.GetBondType()), int(bond.GetStereo()),
                int(bond.GetIsConjugated())]
        rows += [i, j]
        cols += [j, i]
        attrs += [attr, attr]
    edge_index = np.asarray([rows, cols], np.int64)
    edge_attr = np.asarray(attrs, np.int64)
    g = Graph(x=x, edge_index=edge_index, edge_attr=edge_attr)
    g.smiles = smiles
    return g


class ACM4HeCo(InMemoryDataset):
    """ACM graph prepared for HeCo (reference acm4heco.py): paper-author /
    paper-subject bipartite edges + paper features, 20/40/60 label splits."""

    url = "https://github.com/liun-online/HeCo/raw/main/data/acm"

    @property
    def raw_file_names(self):
        return (["pa.txt", "ps.txt", "labels.npy", "p_feat.npz"]
                + [f"{s}_{r}.npy" for s in ("train", "test", "val")
                   for r in (20, 40, 60)])

    def download(self):
        for name in self.raw_file_names:
            download_url(f"{self.url}/{name}", self.raw_dir)

    def process(self):
        import scipy.sparse as sp
        data = HeteroGraph()
        p_feat = sp.load_npz(osp.join(self.raw_dir, "p_feat.npz"))
        data["paper"].x = np.asarray(p_feat.todense(), np.float32)
        data["paper"].y = np.load(
            osp.join(self.raw_dir, "labels.npy")).astype(np.int64)
        pa = np.loadtxt(osp.join(self.raw_dir, "pa.txt"),
                        dtype=np.int64).T
        ps = np.loadtxt(osp.join(self.raw_dir, "ps.txt"),
                        dtype=np.int64).T
        data[("paper", "pa", "author")].edge_index = pa
        data[("author", "ap", "paper")].edge_index = pa[::-1].copy()
        data[("paper", "ps", "subject")].edge_index = ps
        data[("subject", "sp", "paper")].edge_index = ps[::-1].copy()
        data["author"].num_nodes = int(pa[1].max()) + 1
        data["subject"].num_nodes = int(ps[1].max()) + 1
        for ratio in (20, 40, 60):
            for split in ("train", "val", "test"):
                idx = np.load(osp.join(self.raw_dir,
                                       f"{split}_{ratio}.npy"))
                data["paper"][f"{split}_{ratio}"] = idx.astype(np.int64)
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = data
        self.save_data(data, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class Bail(InMemoryDataset):
    """Bail fairness dataset (reference bail.py: FatraGNN release --
    csv features + edge txt per sub-graph B0..B4)."""

    url = "https://raw.githubusercontent.com/liushiliushi/FatraGNN/main/dataset"
    name = "bail"
    parts = ("_B0", "_B1", "_B2", "_B3", "_B4")

    @property
    def raw_dir(self):
        return osp.join(self.root, self.name, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, self.name, "processed")

    @property
    def raw_file_names(self):
        return ([f"{self.name}{p}.csv" for p in self.parts]
                + [f"{self.name}{p}_edges.txt" for p in self.parts])

    def download(self):
        for name in self.raw_file_names:
            download_url(f"{self.url}/{self.name}/{name}", self.raw_dir)

    def process(self):
        graphs = []
        for p in self.parts:
            feats = np.genfromtxt(
                osp.join(self.raw_dir, f"{self.name}{p}.csv"),
                delimiter=",", skip_header=1)
            edges = np.loadtxt(
                osp.join(self.raw_dir, f"{self.name}{p}_edges.txt"),
                dtype=np.int64).T
            # last column is the label, a 'sens' column holds the
            # sensitive attribute (column 0 by FatraGNN convention)
            x = feats[:, :-1].astype(np.float32)
            y = feats[:, -1].astype(np.int64)
            g = Graph(x=x, edge_index=edges, y=y)
            g.sens = x[:, 0]
            graphs.append(g)
        self.data = self.collate(graphs)
        self.save_data(self.data, self.processed_paths[0])


class Credit(Bail):
    """Credit fairness dataset (reference credit.py, same release format)."""

    name = "credit"


class AMiner(InMemoryDataset):
    """AMiner heterogeneous academic graph (reference aminer.py:
    author/paper/venue with metapath2vec label sets)."""

    url = "https://www.dropbox.com/s/1bnz8r7mofx0osf/net_aminer.zip?dl=1"
    y_url = "https://www.dropbox.com/s/nkocx16rpl4ydde/label.zip?dl=1"

    @property
    def raw_file_names(self):
        return ["id_author.txt", "id_conf.txt", "paper.txt",
                "paper_author.txt", "paper_conf.txt", "label"]

    def download(self):
        path = download_url(self.url, self.root, filename="net_aminer.zip")
        extract_zip(path, self.raw_dir)
        os.remove(path)
        path = download_url(self.y_url, self.raw_dir, filename="label.zip")
        extract_zip(path, self.raw_dir)
        os.remove(path)

    def process(self):
        data = HeteroGraph()
        pa = np.loadtxt(osp.join(self.raw_dir, "paper_author.txt"),
                        dtype=np.int64).T
        pc = np.loadtxt(osp.join(self.raw_dir, "paper_conf.txt"),
                        dtype=np.int64).T
        data[("paper", "written_by", "author")].edge_index = pa
        data[("author", "writes", "paper")].edge_index = pa[::-1].copy()
        data[("paper", "published_in", "venue")].edge_index = pc
        data[("venue", "publishes", "paper")].edge_index = pc[::-1].copy()
        data["paper"].num_nodes = int(max(pa[0].max(), pc[0].max())) + 1
        data["author"].num_nodes = int(pa[1].max()) + 1
        data["venue"].num_nodes = int(pc[1].max()) + 1
        self.data = data
        self.save_data(data, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class MoleculeNet(InMemoryDataset):
    """MoleculeNet property-prediction collections (reference
    molecule_net.py): csv of SMILES + targets, converted via `_from_smiles`
    (rdkit-gated)."""

    url = "https://deepchemdata.s3-us-west-1.amazonaws.com/datasets"
    names = {
        "esol": ("delaney-processed.csv", "measured log solubility in mols per litre", "smiles"),
        "freesolv": ("SAMPL.csv", "expt", "smiles"),
        "lipo": ("Lipophilicity.csv", "exp", "smiles"),
        "hiv": ("HIV.csv", "HIV_active", "smiles"),
        "bace": ("bace.csv", "Class", "mol"),
        "bbbp": ("BBBP.csv", "p_np", "smiles"),
    }

    def __init__(self, root=None, name="esol", transform=None,
                 pre_transform=None, pre_filter=None, force_reload=False):
        self.name = name.lower()
        assert self.name in self.names
        super().__init__(root, transform, pre_transform, pre_filter,
                         force_reload=force_reload)

    @property
    def raw_dir(self):
        return osp.join(self.root, self.name, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, self.name, "processed")

    @property
    def raw_file_names(self):
        return [self.names[self.name][0]]

    def download(self):
        download_url(f"{self.url}/{self.raw_file_names[0]}", self.raw_dir)

    def process(self):
        import csv
        _, target_col, smiles_col = self.names[self.name]
        graphs = []
        with open(self.raw_paths[0]) as f:
            for row in csv.DictReader(f):
                try:
                    g = _from_smiles(row[smiles_col])
                except (ValueError, ImportError):
                    continue
                try:
                    g.y = np.asarray([float(row[target_col])], np.float32)
                except ValueError:
                    continue
                if self.pre_filter is None or self.pre_filter(g):
                    graphs.append(g if self.pre_transform is None
                                  else self.pre_transform(g))
        self.data = self.collate(graphs)
        self.save_data(self.data, self.processed_paths[0])


class MovieLens(InMemoryDataset):
    """MovieLens-100k user/movie bipartite ratings (reference ml.py)."""

    url = "https://files.grouplens.org/datasets/movielens/ml-100k.zip"

    @property
    def raw_file_names(self):
        return ["ml-100k/u.data", "ml-100k/u.item", "ml-100k/u.user"]

    def download(self):
        path = download_url(self.url, self.raw_dir)
        extract_zip(path, self.raw_dir)
        os.remove(path)

    def process(self):
        ratings = np.loadtxt(osp.join(self.raw_dir, "ml-100k", "u.data"),
                             dtype=np.int64)
        data = HeteroGraph()
        user, item = ratings[:, 0] - 1, ratings[:, 1] - 1
        data["user"].num_nodes = int(user.max()) + 1
        data["movie"].num_nodes = int(item.max()) + 1
        data[("user", "rates", "movie")].edge_index = np.stack([user, item])
        data[("user", "rates", "movie")].edge_attr = ratings[:, 2].astype(
            np.float32)
        data[("movie", "rated_by", "user")].edge_index = np.stack(
            [item, user])
        self.data = data
        self.save_data(data, self.processed_paths[0])

    def len(self):
        return 1

    def get(self, idx):
        return self.data


class CustomDataset(InMemoryDataset):
    """Wrap user-provided Graph objects in the Dataset interface
    (reference custom_datasets.py)."""

    def __init__(self, graphs, root=None, transform=None,
                 pre_transform=None, force_reload=True):
        if root is None:  # a folder of the temporary directory, as in JAX
            root = osp.join(tempfile.gettempdir(), "ggl_tpu_torch_custom")
        self._graphs = graphs if isinstance(graphs, (list, tuple)) \
            else [graphs]
        super().__init__(root, transform, pre_transform,
                         force_reload=force_reload)

    @property
    def raw_file_names(self):
        return []

    def download(self):
        pass

    def process(self):
        graphs = [g if self.pre_transform is None else self.pre_transform(g)
                  for g in self._graphs]
        self.data = self.collate(graphs)
        self.save_data(self.data, self.processed_paths[0])
