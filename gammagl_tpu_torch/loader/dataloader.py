"""Graph-aware DataLoader (counterpart of `gammagl_tpu/loader/dataloader.py`).

Reference: gammagl/loader/dataloader.py:11 (a Collater over
BatchGraph.from_data_list). Host-side iteration; with ``pad=True`` each
batch is padded to bucketed sizes (`data.padding`), so a model sees a
small, fixed set of shapes.
"""

import numpy as np

from gammagl_tpu_torch.data.batch import BatchGraph
from gammagl_tpu_torch.data.padding import pad_graph, size_bucket

__all__ = ["DataLoader", "Collater"]


class Collater:
    def __init__(self, follow_batch=None, exclude_keys=None,
                 pad=False):
        self.follow_batch = follow_batch
        self.exclude_keys = exclude_keys
        self.pad = pad

    def __call__(self, batch):
        out = BatchGraph.from_data_list(batch,
                                        follow_batch=self.follow_batch,
                                        exclude_keys=self.exclude_keys)
        if self.pad:
            out = pad_graph(out, num_nodes=size_bucket(out.num_nodes),
                            num_edges=size_bucket(out.num_edges))
        return out


class DataLoader:
    """Iterate a dataset in collated batches.

    Parameters mirror the reference loader; ``pad=True`` adds bucket
    padding; ``seed`` seeds the shuffle's ``default_rng``.
    """

    def __init__(self, dataset, batch_size=1, shuffle=False,
                 drop_last=False, follow_batch=None, exclude_keys=None,
                 pad=False, seed=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = Collater(follow_batch, exclude_keys, pad)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, len(order), self.batch_size):
            idx = order[lo:lo + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
