"""Dataset lifecycle: download -> process -> cached load (counterpart of
`gammagl_tpu/data/dataset.py`).

Reference: gammagl/data/dataset.py:27 (Dataset, `_download:240`,
`_process:319`) and in_memory_dataset.py:12 (one collated file). Host
numpy and pickle, as in the JAX package, with one difference: the
processed cache has the port's own name (``data_torch.pkl`` where the JAX
package writes ``data.pkl``). Both packages default to the same root
(``./data``), and a pickle carries its package's classes: each package
reads only the file it wrote, and `load_data` refuses the JAX package's
classes before anything of JAX is imported.
"""

import copy
import os
import os.path as osp
import pickle
import shutil
from typing import Callable, List, Optional, Union

import numpy as np

from gammagl_tpu_torch.data.batch import BatchGraph
from gammagl_tpu_torch.data.graph import Graph, _host, load_pickle

__all__ = ["Dataset", "InMemoryDataset"]


def _to_list(value):
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def files_exist(files):
    return len(files) != 0 and all(osp.exists(f) for f in files)


class Dataset:
    """The reference's raw / processed contract: subclasses define
    `raw_file_names`, `processed_file_names`, `download()` and
    `process()`; raw files are fetched when missing, processed ones made
    when missing (or always, with ``force_reload``)."""

    def __init__(self, root: Optional[str] = None,
                 transform: Optional[Callable] = None,
                 pre_transform: Optional[Callable] = None,
                 pre_filter: Optional[Callable] = None,
                 force_reload: bool = False):
        self.root = (osp.expanduser(root) if root
                     else osp.join(os.getcwd(), "data"))
        self.transform = transform
        self.pre_transform = pre_transform
        self.pre_filter = pre_filter
        self._indices = None
        if force_reload and osp.exists(self.processed_dir):
            shutil.rmtree(self.processed_dir)
        if not files_exist(self.raw_paths):
            self._download()
        if not files_exist(self.processed_paths):
            self._process()

    # -- subclass contract --------------------------------------------------
    @property
    def raw_file_names(self) -> Union[str, List[str]]:
        raise NotImplementedError

    @property
    def processed_file_names(self) -> Union[str, List[str]]:
        raise NotImplementedError

    def download(self):
        raise NotImplementedError

    def process(self):
        raise NotImplementedError

    def len(self) -> int:
        raise NotImplementedError

    def get(self, idx: int) -> Graph:
        raise NotImplementedError

    # -- paths --------------------------------------------------------------
    @property
    def raw_dir(self):
        return osp.join(self.root, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, "processed")

    @property
    def raw_paths(self):
        return [osp.join(self.raw_dir, f)
                for f in _to_list(self.raw_file_names)]

    @property
    def processed_paths(self):
        return [osp.join(self.processed_dir, f)
                for f in _to_list(self.processed_file_names)]

    # -- lifecycle ----------------------------------------------------------
    def _download(self):
        os.makedirs(self.raw_dir, exist_ok=True)
        self.download()

    def _process(self):
        os.makedirs(self.processed_dir, exist_ok=True)
        self.process()

    # -- container protocol -------------------------------------------------
    def indices(self):
        return range(self.len()) if self._indices is None else self._indices

    def __len__(self):
        return len(self.indices())

    def __getitem__(self, idx):
        """An int gives a graph (``transform`` applied); a slice, an index
        array or a boolean mask gives a view of those graphs."""
        if isinstance(idx, (int, np.integer)):
            data = self.get(self.indices()[idx])
            return data if self.transform is None else self.transform(data)
        ds = copy.copy(self)
        if isinstance(idx, slice):
            ds._indices = list(self.indices())[idx]
        else:
            idx = np.asarray(_host(idx))
            if idx.dtype == bool:
                idx = np.nonzero(idx)[0]
            ds._indices = [self.indices()[i] for i in idx.tolist()]
        return ds

    def shuffle(self, rng=None):
        """A view in the order of ``rng.permutation`` (a numpy Generator;
        None: a fresh one)."""
        rng = rng or np.random.default_rng()
        return self[rng.permutation(len(self))]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- stats --------------------------------------------------------------
    @property
    def num_node_features(self):
        return self[0].num_node_features

    num_features = num_node_features

    @property
    def num_classes(self):
        ys = [int(np.asarray(_host(g.y)).max()) for g in self if "y" in g]
        return max(ys) + 1 if ys else 0

    def __repr__(self):
        return f"{self.__class__.__name__}({len(self)})"


class InMemoryDataset(Dataset):
    """A dataset held as one collated `BatchGraph`, pickled once to
    ``processed/data_torch.pkl`` (reference in_memory_dataset.py:
    `collate:109`, slice-dict `get:88`)."""

    def __init__(self, root=None, transform=None, pre_transform=None,
                 pre_filter=None, force_reload=False):
        self.data: Optional[BatchGraph] = None
        self._data_list = None
        super().__init__(root, transform, pre_transform, pre_filter,
                         force_reload)
        if files_exist(self.processed_paths) and self.data is None:
            self.data = self.load_data(self.processed_paths[0])

    @property
    def processed_file_names(self):
        return "data_torch.pkl"

    @staticmethod
    def collate(data_list: List[Graph]) -> BatchGraph:
        return BatchGraph.from_data_list(data_list)

    def save_data(self, data, path):
        with open(path, "wb") as f:
            pickle.dump(data, f)

    def load_data(self, path):
        with open(path, "rb") as f:
            return load_pickle(f)

    def len(self):
        if self.data is None:
            return 0
        if self.data._num_graphs is not None:
            return self.data._num_graphs
        return 1

    def get(self, idx):
        if self.data._num_graphs is None or self.data._num_graphs == 1:
            return self.data
        # the graphs are separated once, not on every access
        if self._data_list is None or self._data_list[0] is not self.data:
            self._data_list = (self.data, self.data.to_data_list())
        return self._data_list[1][idx]
