"""TUDataset: graph-classification collections such as MUTAG, PROTEINS,
ENZYMES (counterpart of `gammagl_tpu/datasets/tu_dataset.py`; reference:
gammagl/datasets/tu_dataset.py). Raw files go under
``<root>/<name>/raw/<name>_*.txt``."""

import os
import os.path as osp
import shutil

from gammagl_tpu_torch.data.dataset import InMemoryDataset
from gammagl_tpu_torch.data.download import download_url, extract_zip
from gammagl_tpu_torch.io.tu import read_tu_data

__all__ = ["TUDataset"]


class TUDataset(InMemoryDataset):
    url = "https://www.chrsmrrs.com/graphkerneldatasets"

    def __init__(self, root=None, name="MUTAG", transform=None,
                 pre_transform=None, pre_filter=None, force_reload=False):
        self.name = name
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
        return [f"{self.name}_A.txt", f"{self.name}_graph_indicator.txt"]

    def download(self):
        path = download_url(f"{self.url}/{self.name}.zip", self.root)
        extract_zip(path, self.root)
        os.unlink(path)
        if osp.exists(self.raw_dir):
            shutil.rmtree(self.raw_dir)
        os.makedirs(osp.dirname(self.raw_dir), exist_ok=True)
        shutil.move(osp.join(self.root, self.name), self.raw_dir + "_tmp")
        os.makedirs(self.raw_dir.rsplit("/raw")[0], exist_ok=True)
        shutil.move(self.raw_dir + "_tmp", self.raw_dir)

    def process(self):
        graphs = read_tu_data(self.raw_dir, self.name)
        if self.pre_filter is not None:
            graphs = [g for g in graphs if self.pre_filter(g)]
        if self.pre_transform is not None:
            graphs = [self.pre_transform(g) for g in graphs]
        self.data = self.collate(graphs)
        self.save_data(self.data, self.processed_paths[0])
