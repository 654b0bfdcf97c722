"""Edge coalescing and sorting (counterpart of
`gammagl_tpu/utils/coalesce.py`).

Host-side numpy graph canonicalization, as in the JAX package: the
outputs' sizes depend on the data, and they run once while a graph is
prepared."""

import numpy as np

__all__ = ["coalesce", "sort_edge_index"]


def sort_edge_index(edge_index, edge_attr=None, num_nodes=None,
                    sort_by_row=True):
    """Sort edges lexicographically by (row, col), or by (col, row)."""
    ei = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1 if ei.size else 0
    key = (ei[0] * num_nodes + ei[1] if sort_by_row
           else ei[1] * num_nodes + ei[0])
    perm = np.argsort(key, kind="stable")
    out = ei[:, perm]
    if edge_attr is None:
        return out
    if isinstance(edge_attr, (list, tuple)):
        return out, [np.asarray(a)[perm] for a in edge_attr]
    return out, np.asarray(edge_attr)[perm]


def _reduce(attr, inverse, n, reduce):
    shape = (n,) + attr.shape[1:]
    if reduce in ("sum", "add"):
        red = np.zeros(shape, attr.dtype)
        np.add.at(red, inverse, attr)
        return red
    if reduce == "mean":
        red = np.zeros(shape, np.float64)
        np.add.at(red, inverse, attr)
        cnt = np.zeros(n, np.int64)
        np.add.at(cnt, inverse, 1)
        return (red / cnt.reshape((-1,) + (1,) * (attr.ndim - 1))).astype(
            attr.dtype)
    if reduce in ("max", "min"):
        red = np.full(shape, -np.inf if reduce == "max" else np.inf,
                      np.float64)
        (np.maximum if reduce == "max" else np.minimum).at(red, inverse,
                                                           attr)
        return red.astype(attr.dtype)
    if reduce == "mul":
        red = np.ones(shape, attr.dtype)
        np.multiply.at(red, inverse, attr)
        return red
    raise ValueError(f"unknown reduce {reduce!r}")


def coalesce(edge_index, edge_attr=None, num_nodes=None, reduce="sum",
             is_sorted=False):
    """Sort the edges by (row, col) and keep one of each; the attributes
    of duplicates are reduced ('sum' | 'add' | 'mean' | 'max' | 'min' |
    'mul')."""
    ei = np.asarray(edge_index)
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1 if ei.size else 0
    key = ei[0].astype(np.int64) * num_nodes + ei[1]
    if not is_sorted:
        perm = np.argsort(key, kind="stable")
        ei, key = ei[:, perm], key[perm]
        if edge_attr is not None:
            edge_attr = np.asarray(edge_attr)[perm]
    uniq, first_idx, inverse = np.unique(key, return_index=True,
                                         return_inverse=True)
    out = ei[:, first_idx]
    if edge_attr is None:
        return out
    return out, _reduce(np.asarray(edge_attr), inverse, len(uniq), reduce)
