"""Global graph pooling (counterpart of `gammagl_tpu/layers/pool/glob.py`).

``batch`` maps each node to its graph; the readouts are the COO segment
reductions over it (`ops.segment`), as in the JAX package, which reduces
with XLA's segment ops: no kernel runs here. ``batch=None`` pools all
rows into one (1, F) row.
"""

import torch

from gammagl_tpu_torch.ops.segment import (segment_max, segment_mean,
                                           segment_min, segment_sum)
from gammagl_tpu_torch.utils.to_dense import to_dense_batch

__all__ = ["global_sum_pool", "global_add_pool", "global_mean_pool",
           "global_max_pool", "global_min_pool", "global_sort_pool"]


def _num_graphs(batch, num_graphs):
    return int(batch.max()) + 1 if num_graphs is None else num_graphs


def global_sum_pool(x, batch, num_graphs=None):
    if batch is None:
        return x.sum(0, keepdim=True)
    return segment_sum(x, batch, _num_graphs(batch, num_graphs))


global_add_pool = global_sum_pool


def global_mean_pool(x, batch, num_graphs=None):
    if batch is None:
        return x.mean(0, keepdim=True)
    return segment_mean(x, batch, _num_graphs(batch, num_graphs))


def global_max_pool(x, batch, num_graphs=None):
    """Max per graph; an empty graph gives 0."""
    if batch is None:
        return x.amax(0, keepdim=True)
    return segment_max(x, batch, _num_graphs(batch, num_graphs))


def global_min_pool(x, batch, num_graphs=None):
    """Min per graph; an empty graph gives 0."""
    if batch is None:
        return x.amin(0, keepdim=True)
    return segment_min(x, batch, _num_graphs(batch, num_graphs))


def global_sort_pool(x, batch, k, num_graphs=None):
    """Sort pooling: each graph's rows sorted by their last channel,
    largest first (ties keep the node order), the first ``k`` kept and
    flattened to (B, k * F). A graph of fewer than k nodes is padded with
    zero rows; every -inf in the kept rows is 0, as in the JAX package
    (which pads through a -inf fill)."""
    B = _num_graphs(batch, num_graphs) if batch is not None else 1
    dense, _ = to_dense_batch(x, batch, fill_value=-float("inf"),
                              batch_size=B)
    order = torch.argsort(-dense[..., -1], dim=1, stable=True)
    rows = torch.take_along_dim(dense, order[..., None], dim=1)[:, :k]
    rows = rows.masked_fill(torch.isneginf(rows), 0.0)
    if rows.shape[1] < k:
        rows = torch.cat([rows, rows.new_zeros(
            (B, k - rows.shape[1], x.shape[-1]))], 1)
    return rows.reshape(B, k * x.shape[-1])
