"""A feature table on the card with a host fallback (counterpart of
`gammagl_tpu/loader/feature_cache.py`'s `DeviceFeatureCache`).

Reference: gammagl/gglspeedup/gpufeature.py. The degree-hottest rows of
the feature matrix live on the card as one tensor within a byte budget
("0.1G"); the rest stay on the host in pinned memory. A gather takes the
cached rows on the card and moves only the missing ones: an
``index_select`` on the host into a pinned buffer, one ``non_blocking``
copy, and an ``index_copy_`` into the output. Hit and miss counts mirror
the reference's budget tuning.
"""

import numpy as np
import torch

from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["DeviceFeatureCache"]


def _budget_rows(budget_bytes, row_bytes):
    if isinstance(budget_bytes, str):
        mult = {"K": 2**10, "M": 2**20, "G": 2**30}[
            budget_bytes[-1].upper()]
        budget_bytes = float(budget_bytes[:-1]) * mult
    return int(budget_bytes // row_bytes)


class DeviceFeatureCache:
    """Hot-row cache on the card with a host fallback (reference
    gpufeature.py:12-80).

    Parameters
    ----------
    features : (N, F) host numpy array, the whole feature matrix.
    budget_rows : number of rows kept on the card (default: all of them,
        or what ``budget_bytes`` holds).
    budget_bytes : the budget as bytes or a string such as "0.1G".
    score : optional (N,) hotness score (degree); the highest are cached.
        None caches the first rows.
    device : where the cache lives (None: the current card; raises when
        there is none, so ask for "cpu" to run on the host).
    """

    def __init__(self, features, budget_rows=None, budget_bytes=None,
                 score=None, device=None):
        self.features = np.asarray(features)
        n, f = self.features.shape
        if budget_rows is None:
            budget_rows = (n if budget_bytes is None else _budget_rows(
                budget_bytes, f * self.features.dtype.itemsize))
        self.budget_rows = min(budget_rows, n)
        order = (np.argsort(-np.asarray(score))
                 if score is not None else np.arange(n))
        self.hot_ids = order[:self.budget_rows]
        # global id -> cache slot; -1 = miss
        self.slot_of = np.full(n, -1, np.int64)
        self.slot_of[self.hot_ids] = np.arange(self.budget_rows)
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        host = torch.from_numpy(np.ascontiguousarray(self.features))
        self.host = host.pin_memory() if self._pin else host
        self.features = self.host.numpy()  # one host copy: the pinned one
        self.hot = self.host.index_select(
            0, torch.from_numpy(self.hot_ids)).to(self.device)
        self.hits = 0
        self.misses = 0

    def _from_host(self, ids):
        """Rows ``ids`` of the host matrix on the device: gathered into a
        pinned buffer, then one asynchronous copy."""
        ids = torch.from_numpy(np.ascontiguousarray(ids, np.int64))
        if not self._pin:
            return self.host.index_select(0, ids).to(self.device)
        buf = torch.empty((len(ids),) + tuple(self.host.shape[1:]),
                          dtype=self.host.dtype, pin_memory=True)
        torch.index_select(self.host, 0, ids, out=buf)
        return buf.to(self.device, non_blocking=True)

    def __getitem__(self, idx):
        """Rows ``idx`` (global ids) as a tensor on the device: cached rows
        from the card, the rest copied from the host."""
        idx = np.asarray(idx)
        if self.budget_rows == 0:       # cache disabled: a host gather
            self.misses += int(idx.shape[0])
            return self._from_host(idx)
        slots = self.slot_of[idx]
        hit = slots >= 0
        self.hits += int(hit.sum())
        self.misses += int((~hit).sum())
        out = self.hot.index_select(0, torch.from_numpy(
            np.where(hit, slots, 0)).to(self.device, non_blocking=True))
        if (~hit).any():
            pos = torch.from_numpy(np.nonzero(~hit)[0]).to(
                self.device, non_blocking=True)
            out.index_copy_(0, pos, self._from_host(idx[~hit]))
        return out

    @property
    def hit_rate(self):
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
