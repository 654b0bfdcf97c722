"""Mask and index conversion (counterpart of `gammagl_tpu/utils/mask.py`).

A tensor argument keeps its device; a numpy argument gives numpy, the
values the JAX functions give on the host."""

import numpy as np
import torch

__all__ = ["mask_to_index", "index_to_mask"]


def mask_to_index(mask):
    """Boolean mask -> int64 positions of its True entries."""
    if isinstance(mask, torch.Tensor):
        return torch.nonzero(mask.reshape(-1), as_tuple=True)[0]
    return np.nonzero(np.asarray(mask))[0]


def index_to_mask(index, size=None):
    """A boolean mask of ``size`` with ``index`` set. As the JAX scatter,
    a negative id counts from the end and an id out of range is dropped
    (a padded graph's pad id ``num_nodes``), so the card never sees an
    index out of bounds."""
    if isinstance(index, torch.Tensor):
        index = index.reshape(-1).long()
        if size is None:
            size = int(index.max()) + 1
        index = torch.where(index < 0, index + size, index)
        keep = (index >= 0) & (index < size)
        index = torch.where(keep, index, size)  # the spill slot, cut off
        mask = torch.zeros(size + 1, dtype=torch.bool, device=index.device)
        return mask.index_fill_(0, index, True)[:size]
    index = np.asarray(index).reshape(-1).astype(np.int64)
    if size is None:
        size = int(index.max()) + 1
    index = np.where(index < 0, index + size, index)
    mask = np.zeros(size, dtype=bool)
    mask[index[(index >= 0) & (index < size)]] = True
    return mask
