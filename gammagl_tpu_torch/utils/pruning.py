"""Magnitude pruning (UniFews), counterpart of `gammagl_tpu/utils/pruning.py`.

Entry-wise thresholding of weights and of edge weights, realised as
masking, as in the JAX package. The parameter helpers take a tree of
tensors: a mapping (a module's ``state_dict()``), a list or a tuple,
nested, with tensors at the leaves; they return a tree of the same shape.
"""

from collections.abc import Mapping

import torch

__all__ = ["threshold_prune", "prune_params", "rewind", "sparsity",
           "prune_edges_by_weight"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return type(first)((k, _tree_map(fn, *(t[k] for t in trees)))
                           for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def threshold_prune(x, thr):
    """Zero the entries with |x| < thr; returns (pruned, mask)."""
    mask = x.abs() >= thr
    return x * mask, mask


def prune_params(params, thr):
    """`threshold_prune` on every leaf of ``params``; returns (pruned
    tree, tree of masks)."""
    return (_tree_map(lambda p: threshold_prune(p, thr)[0], params),
            _tree_map(lambda p: threshold_prune(p, thr)[1], params))


def rewind(params, init_params, masks):
    """Lottery-ticket rewind: the surviving weights reset to their initial
    values (``init * mask``); ``params`` is not read."""
    return _tree_map(lambda init, m: init * m, init_params, masks)


def sparsity(masks):
    """Fraction of zeros across every mask leaf."""
    leaves = list(_leaves(masks))
    total = sum(m.numel() for m in leaves)
    nnz = sum(int(m.sum()) for m in leaves)
    return 1.0 - nnz / max(total, 1)


def prune_edges_by_weight(edge_weight, thr):
    """UniFews message pruning: an edge with |w| < thr gets weight 0, an
    exact no-op in every sum."""
    return torch.where(edge_weight.abs() >= thr, edge_weight,
                       torch.zeros((), dtype=edge_weight.dtype,
                                   device=edge_weight.device))
