"""Planetoid citation datasets: Cora, Citeseer, Pubmed (counterpart of
`gammagl_tpu/datasets/planetoid.py`; reference:
gammagl/datasets/planetoid.py:15, splits 'public' | 'full' | 'random').

Raw files go under ``<root>/<name>/raw/`` (``ind.<name>.*``, the format of
github.com/kimiyoung/planetoid); they are fetched only when missing and
``GGL_TPU_OFFLINE`` is unset. The processed graph is cached in
``<root>/<name>/processed/data_torch.pkl``.
"""

import os.path as osp

import numpy as np

from gammagl_tpu_torch.data.dataset import InMemoryDataset
from gammagl_tpu_torch.data.download import download_url
from gammagl_tpu_torch.io.planetoid import read_planetoid_data

__all__ = ["Planetoid"]


class Planetoid(InMemoryDataset):
    url = "https://github.com/kimiyoung/planetoid/raw/master/data"

    def __init__(self, root=None, name="cora", split="public",
                 num_train_per_class=20, num_val=500, num_test=1000,
                 transform=None, pre_transform=None, force_reload=False):
        self.name = name.lower()
        assert self.name in ("cora", "citeseer", "pubmed")
        self.split = split
        self.num_train_per_class = num_train_per_class
        self.num_val = num_val
        self.num_test = num_test
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
        names = ["x", "tx", "allx", "y", "ty", "ally", "graph",
                 "test.index"]
        return [f"ind.{self.name}.{n}" for n in names]

    def download(self):
        for name in self.raw_file_names:
            download_url(f"{self.url}/{name}", self.raw_dir)

    def process(self):
        data = read_planetoid_data(self.raw_dir, self.name)
        if self.split == "full":
            data.train_mask = ~(data.val_mask | data.test_mask)
        elif self.split == "random":
            # the JAX package's draw: numpy's Generator at seed 0
            rng = np.random.default_rng(0)
            y = data.y
            n = y.shape[0]
            train = np.zeros(n, bool)
            for c in range(int(y.max()) + 1):
                idx = rng.permutation(np.nonzero(y == c)[0])
                train[idx[:self.num_train_per_class]] = True
            rest = rng.permutation(np.nonzero(~train)[0])
            val = np.zeros(n, bool)
            val[rest[:self.num_val]] = True
            test = np.zeros(n, bool)
            test[rest[self.num_val:self.num_val + self.num_test]] = True
            data.train_mask, data.val_mask, data.test_mask = train, val, test
        if self.pre_transform is not None:
            data = self.pre_transform(data)
        self.data = self.collate([data])
        self.save_data(self.data, self.processed_paths[0])
