"""Assorted graph utilities, counterpart of `gammagl_tpu/utils/misc.py`:
homophily, the graph Laplacian, scipy conversions and random splits
(reference: gammagl/utils/{homophily,get_laplacian,convert,get_split}.py).

`homophily` and the conversions take tensors or numpy arrays and return
host values; `get_laplacian` works on tensors, on their device.
"""

import numpy as np
import torch

from gammagl_tpu_torch.ops.segment import segment_mean
from gammagl_tpu_torch.utils.degree import degree

__all__ = [
    "homophily",
    "get_laplacian",
    "to_scipy_sparse_matrix",
    "from_scipy_sparse_matrix",
    "get_train_val_test_split",
]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def homophily(edge_index, y, method="edge"):
    """Edge homophily (the share of edges whose ends have one label) or
    node homophily (each node's share of in-edges from its label, averaged
    over the nodes that have in-edges; by `segment_mean` and `degree`)."""
    src, dst = _np(edge_index)
    y = _np(y)
    same = (y[src] == y[dst]).astype(np.float32)
    if method == "edge":
        return float(same.mean())
    if method == "node":
        num_nodes = len(y)
        dst_t = torch.from_numpy(np.ascontiguousarray(dst))
        out = segment_mean(torch.from_numpy(same), dst_t, num_nodes).numpy()
        deg = degree(dst_t, num_nodes).numpy()
        return float(out[deg > 0].mean())
    raise ValueError(f"unknown method {method!r}")


def get_laplacian(edge_index, num_nodes, edge_weight=None,
                  normalization=None):
    """The graph Laplacian as edges: L = D - A (``None``), I - D^-1/2 A
    D^-1/2 (``"sym"``) or I - D^-1 A (``"rw"``). D counts each node's
    in-edges (unweighted, as in the JAX package). Returns (edge_index,
    weight): the edges, then the N diagonal entries appended."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    if edge_weight is None:
        edge_weight = torch.ones(src.shape[0], device=edge_index.device)
    deg = degree(dst, num_nodes, dtype=edge_weight.dtype)
    diag = torch.arange(num_nodes, dtype=edge_index.dtype,
                        device=edge_index.device)
    ones = torch.ones(num_nodes, dtype=edge_weight.dtype,
                      device=edge_weight.device)
    if normalization is None:
        w = torch.cat([-edge_weight, deg])
    elif normalization == "sym":
        dis = torch.where(deg > 0, deg.pow(-0.5), 0.0)
        w = torch.cat([-dis[src] * edge_weight * dis[dst], ones])
    elif normalization == "rw":
        dinv = torch.where(deg > 0, 1.0 / deg, 0.0)
        w = torch.cat([-dinv[dst] * edge_weight, ones])
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    ei = torch.cat([edge_index, torch.stack([diag, diag])], dim=1)
    return ei, w


def to_scipy_sparse_matrix(edge_index, edge_attr=None, num_nodes=None):
    """A scipy COO matrix of the edges (values ``edge_attr`` or 1)."""
    import scipy.sparse as sp
    ei = _np(edge_index)
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1 if ei.size else 0
    vals = (np.ones(ei.shape[1]) if edge_attr is None
            else _np(edge_attr).reshape(-1))
    return sp.coo_matrix((vals, (ei[0], ei[1])),
                         shape=(num_nodes, num_nodes))


def from_scipy_sparse_matrix(mat):
    """(edge_index int64, values) of a scipy sparse matrix, numpy."""
    mat = mat.tocoo()
    return (np.stack([mat.row, mat.col]).astype(np.int64),
            np.asarray(mat.data))


def get_train_val_test_split(num_nodes, train_per_class=None, labels=None,
                             num_classes=None, train_ratio=0.1,
                             val_ratio=0.1, rng=None):
    """Random split masks (train, val, test), numpy booleans: by ratios,
    or ``train_per_class`` nodes of each class when ``labels`` are given.
    ``rng``: a numpy Generator (None: ``default_rng(0)``); the JAX
    package's draws in the same order, so one seed gives one split."""
    rng = rng or np.random.default_rng(0)
    perm = rng.permutation(num_nodes)
    if train_per_class is not None and labels is not None:
        labels = _np(labels)
        if num_classes is None:
            num_classes = int(labels.max()) + 1
        train_idx = np.concatenate([
            rng.permutation(np.nonzero(labels == c)[0])[:train_per_class]
            for c in range(num_classes)])
        rest = np.setdiff1d(perm, train_idx)
        n_val = int(val_ratio * num_nodes)
        val_idx, test_idx = rest[:n_val], rest[n_val:]
    else:
        n_train = int(train_ratio * num_nodes)
        n_val = int(val_ratio * num_nodes)
        train_idx = perm[:n_train]
        val_idx = perm[n_train:n_train + n_val]
        test_idx = perm[n_train + n_val:]

    def mask(idx):
        m = np.zeros(num_nodes, dtype=bool)
        m[idx] = True
        return m
    return mask(train_idx), mask(val_idx), mask(test_idx)
