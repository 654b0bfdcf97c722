"""Node degree (counterpart of `gammagl_tpu/utils/degree.py`)."""

import numpy as np
import torch

from gammagl_tpu_torch.ops.segment import segment_count

__all__ = ["degree"]


def degree(index, num_nodes=None, dtype=torch.float32):
    """How often each node id occurs in ``index``, on the port's
    `segment_count`: counted in float32 (a bfloat16 count does not
    saturate at 256, ROADMAP C1) and cast to ``dtype``; ids out of
    [0, num_nodes) are dropped. ``num_nodes`` defaults to max(index) + 1.
    A tensor keeps its device; a numpy array gives numpy (float32 for
    the default ``dtype``)."""
    if isinstance(index, torch.Tensor):
        if num_nodes is None:
            num_nodes = int(index.max()) + 1
        return segment_count(index.reshape(-1), num_nodes, dtype=dtype)
    index = np.asarray(index).reshape(-1)
    if num_nodes is None:
        num_nodes = int(index.max()) + 1
    out = segment_count(torch.from_numpy(index.astype(np.int64)), num_nodes,
                        dtype=dtype)
    # numpy has no bfloat16: its values come back as float32
    return (out.float() if dtype == torch.bfloat16 else out).numpy()
