"""Dense conversions (counterpart of `gammagl_tpu/utils/to_dense.py`):
COO edges to a dense adjacency, ragged node rows to a padded batch."""

import torch

from gammagl_tpu_torch.ops.segment import segment_count

__all__ = ["to_dense_adj", "to_dense_batch"]


def _local_ids(batch, batch_size, max_num_nodes):
    """(batch_size, max_num_nodes, each node's index inside its graph):
    the graphs' node counts from ``batch`` (nodes of one graph
    consecutive), sizes that are None taken from them."""
    if batch_size is None:
        batch_size = int(batch.max()) + 1
    counts = segment_count(batch, batch_size).long()
    if max_num_nodes is None:
        max_num_nodes = int(counts.max())
    ptr = torch.cumsum(counts, 0) - counts
    # a graph id outside [0, batch_size) (a padded node) reads any ptr:
    # its row is dropped
    local = torch.arange(batch.shape[0], device=batch.device) - ptr[
        batch.clamp(0, max(batch_size - 1, 0))]
    return batch_size, max_num_nodes, local


def to_dense_adj(edge_index, batch=None, edge_attr=None, max_num_nodes=None,
                 batch_size=None):
    """COO edges -> dense adjacency: (N, N[, F]) without ``batch``, else
    (B, N_max, N_max[, F]) with each graph's block at its own node ids.
    Repeated edges add up; values are float32 ones, or ``edge_attr``
    (E[, F]) in its dtype."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    vals = (torch.ones(src.shape[0], device=src.device) if edge_attr is None
            else edge_attr)
    tail = tuple(vals.shape[1:])
    if batch is None:
        n = max_num_nodes or int(edge_index.max()) + 1
        return torch.zeros((n, n) + tail, dtype=vals.dtype,
                           device=vals.device).index_put_(
            (src, dst), vals, accumulate=True)
    batch = torch.as_tensor(batch, device=src.device).long()
    batch_size, max_num_nodes, local = _local_ids(batch, batch_size,
                                                  max_num_nodes)
    out = torch.zeros((batch_size, max_num_nodes, max_num_nodes) + tail,
                      dtype=vals.dtype, device=vals.device)
    return out.index_put_((batch[src], local[src], local[dst]), vals,
                          accumulate=True)


def to_dense_batch(x, batch=None, fill_value=0.0, max_num_nodes=None,
                   batch_size=None):
    """Ragged node rows -> ((B, N_max, ...) padded with ``fill_value``,
    (B, N_max) bool mask of the real rows). Without ``batch`` the whole
    of x is one graph. A node past ``max_num_nodes`` in its graph, or of
    a graph id outside [0, batch_size) (a padded node), is dropped, as
    the JAX scatter drops it."""
    if batch is None:
        return x[None], torch.ones((1, x.shape[0]), dtype=torch.bool,
                                   device=x.device)
    batch = torch.as_tensor(batch, device=x.device).long()
    batch_size, max_num_nodes, local = _local_ids(batch, batch_size,
                                                  max_num_nodes)
    keep = (local < max_num_nodes) & (batch >= 0) & (batch < batch_size)
    b, local = batch[keep], local[keep]
    out = torch.full((batch_size, max_num_nodes) + tuple(x.shape[1:]),
                     fill_value, dtype=x.dtype, device=x.device)
    out = out.index_put((b, local), x[keep])
    mask = torch.zeros((batch_size, max_num_nodes), dtype=torch.bool,
                       device=x.device)
    mask[b, local] = True
    return out, mask
