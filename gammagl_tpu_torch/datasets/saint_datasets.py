"""GraphSAINT-format datasets: Flickr, Yelp (adj_full.npz + feats.npy +
class_map.json + role.json).

Counterpart of `gammagl_tpu/datasets/saint_datasets.py` (reference:
gammagl/datasets/{flickr,yelp}.py, google-drive file ids). Yelp is
multilabel. The processed cache is the port's own (``data_torch.pkl``).
"""

import json
import os
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data import InMemoryDataset, download_url
from gammagl_tpu_torch.data.graph import Graph

__all__ = ["Flickr", "Yelp"]


class _SaintFormat(InMemoryDataset):
    url = "https://docs.google.com/uc?export=download&id={}&confirm=t"
    adj_full_id = None
    feats_id = None
    class_map_id = None
    role_id = None
    multilabel = False

    @property
    def raw_file_names(self):
        return ["adj_full.npz", "feats.npy", "class_map.json", "role.json"]

    def download(self):
        ids = [self.adj_full_id, self.feats_id, self.class_map_id,
               self.role_id]
        for fid, fname in zip(ids, self.raw_file_names):
            path = download_url(self.url.format(fid), self.raw_dir)
            os.rename(path, osp.join(self.raw_dir, fname))

    def process(self):
        import scipy.sparse as sp

        f = np.load(osp.join(self.raw_dir, "adj_full.npz"))
        adj = sp.csr_matrix((f["data"], f["indices"], f["indptr"]),
                            f["shape"]).tocoo()
        edge_index = np.stack([adj.row, adj.col]).astype(np.int64)
        x = np.load(osp.join(self.raw_dir, "feats.npy")).astype(np.float32)
        with open(osp.join(self.raw_dir, "class_map.json")) as fh:
            class_map = json.load(fh)
        if self.multilabel:
            n_cls = len(next(iter(class_map.values())))
            y = np.zeros((x.shape[0], n_cls), np.float32)
            for k, v in class_map.items():
                y[int(k)] = v
        else:
            y = np.full(x.shape[0], -1, np.int64)
            for k, v in class_map.items():
                y[int(k)] = v
        with open(osp.join(self.raw_dir, "role.json")) as fh:
            role = json.load(fh)
        g = Graph(x=x, edge_index=edge_index, y=y)
        for name, key in (("train_mask", "tr"), ("val_mask", "va"),
                          ("test_mask", "te")):
            mask = np.zeros(x.shape[0], bool)
            mask[np.asarray(role[key])] = True
            g[name] = mask
        if self.pre_transform is not None:
            g = self.pre_transform(g)
        self.data = self.collate([g])
        self.save_data(self.data, self.processed_paths[0])


class Flickr(_SaintFormat):
    adj_full_id = "1crmsTbd1-2sEXsGwa2IKnIB7Zd3TmUsy"
    feats_id = "1join-XdvX3anJU_MLVtick7MgeAQiWIZ"
    class_map_id = "1uxIkbtg5drHTsKt-PAsZZ4_yJmgFmle9"
    role_id = "1htXCtuktuCW8TR8KiKfrFDAxUgekQoV7"


class Yelp(_SaintFormat):
    adj_full_id = "1Juwx8HtDwSzmVIJ31ooVa1WljI4U5JnA"
    feats_id = "1Zy6BZH_zLEjKlEFSduKE5tV9qqA_8VtM"
    class_map_id = "1VUcBGr0T0-klqerjAjxRmAqFuld_SMWU"
    role_id = "1NI5pa5Chpd-cqk8lKBx6fhLHnPsEdqNl"
    multilabel = True
