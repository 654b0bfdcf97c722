"""Datasets stored as sparse .npz (counterpart of
`gammagl_tpu/datasets/npz_datasets.py`): Amazon (Computers, Photo),
Coauthor (CS, Physics), and the single-file npz graphs FacebookPagePage,
DeezerEurope and GitHub. Reference: gammagl/datasets/{amazon, coauthor,
facebook, deezer_europe, github}.py."""

import os.path as osp

import numpy as np

from gammagl_tpu_torch.data.dataset import InMemoryDataset
from gammagl_tpu_torch.data.download import download_url
from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.io.npz import read_npz

__all__ = ["Amazon", "Coauthor", "FacebookPagePage", "DeezerEurope",
           "GitHub"]


class Amazon(InMemoryDataset):
    url = "https://github.com/shchur/gnn-benchmark/raw/master/data/npz/"

    def __init__(self, root=None, name="computers", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in ("computers", "photo")
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
        return f"amazon_electronics_{self.name}.npz"

    def download(self):
        download_url(self.url + self.raw_file_names, self.raw_dir)

    def process(self):
        data = read_npz(self.raw_paths[0])
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = self.collate([data])
        self.save_data(self.data, self.processed_paths[0])


class Coauthor(Amazon):
    def __init__(self, root=None, name="cs", transform=None,
                 pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in ("cs", "physics")
        InMemoryDataset.__init__(self, root, transform, pre_transform,
                                 force_reload=force_reload)

    @property
    def raw_file_names(self):
        return f"ms_academic_{'cs' if self.name == 'cs' else 'phy'}.npz"


class _SingleNpz(InMemoryDataset):
    """One .npz with x (or features), edge_index (or edges, (E, 2)) and
    y (or target) arrays."""

    url = None
    file_name = None

    @property
    def raw_file_names(self):
        return self.file_name

    def download(self):
        download_url(self.url, self.raw_dir, filename=self.file_name)

    def process(self):
        with np.load(self.raw_paths[0], allow_pickle=True) as f:
            keys = set(f.keys())
            x = f["features"] if "features" in keys else f["x"]
            ei = f["edge_index"] if "edge_index" in keys else f["edges"].T
            y = f["target"] if "target" in keys else f["y"]
        data = Graph(x=np.asarray(x, np.float32),
                     edge_index=np.asarray(ei, np.int64),
                     y=np.asarray(y, np.int64))
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = self.collate([data])
        self.save_data(self.data, self.processed_paths[0])


class FacebookPagePage(_SingleNpz):
    url = "https://graphmining.ai/datasets/ptg/facebook.npz"
    file_name = "facebook.npz"


class DeezerEurope(_SingleNpz):
    url = "https://graphmining.ai/datasets/ptg/deezer_europe.npz"
    file_name = "deezer_europe.npz"


class GitHub(_SingleNpz):
    url = ("https://raw.githubusercontent.com/EdisonLeeeee/GraphData/"
           "master/datasets/git_web_sp.npz")
    file_name = "git_web_sp.npz"
