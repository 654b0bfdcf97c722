"""Load a flax parameter tree of the JAX package into a port module.

A port module that has parameters names its flax counterparts in a
``flax_tree()`` method: a mapping from the flax name (``"GCNConv_0"``,
``"Dense_0"``, ``"bias"``) to a submodule or a parameter. An
``nn.Linear`` stands for a flax ``Dense``: its (out, in) weight is the
transpose of the (in, out) ``kernel``; an ``nn.Conv1d`` for a flax
``Conv`` of one spatial axis: its (out, in, width) weight is the
(width, in, out) ``kernel`` with its axes reversed; an ``nn.LayerNorm``
for a flax ``LayerNorm``, its weight the ``scale``. Raw parameters keep
their flax shape, whatever their rank: HGT's (H, D, D) relation
matrices, its (H,) priors and its scalar skip gates.

A module that keeps state of another flax collection (NodeID's codebooks,
JAX's ``vq_stats``) names it in a ``flax_state()`` method: a mapping from
the collection to {flax name: buffer}. The collection's tree follows the
modules' flax names, as the parameters' does.
"""

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

__all__ = ["load_jax_params"]


def _layout(module, prefix=(), collection="params"):
    """flax path -> (torch parameter, the permutation of the flax array's
    axes that gives the parameter's, or None); for another ``collection``,
    flax path -> (buffer, None)."""
    if collection != "params":
        out = {}
        if hasattr(module, "flax_state"):
            out.update({prefix + (name,): (buf, None) for name, buf in
                        module.flax_state().get(collection, {}).items()})
        if hasattr(module, "flax_tree"):
            for name, child in module.flax_tree().items():
                if isinstance(child, nn.Module):
                    out.update(_layout(child, prefix + (name,), collection))
        return out
    if isinstance(module, (nn.Linear, nn.Conv1d)):
        perm = (1, 0) if isinstance(module, nn.Linear) else (2, 1, 0)
        out = {prefix + ("kernel",): (module.weight, perm)}
        if module.bias is not None:
            out[prefix + ("bias",)] = (module.bias, None)
        return out
    if isinstance(module, nn.LayerNorm):
        return {prefix + ("scale",): (module.weight, None),
                prefix + ("bias",): (module.bias, None)}
    if not hasattr(module, "flax_tree"):
        raise TypeError(f"{type(module).__name__} names no flax "
                        "counterpart (no flax_tree method)")
    out = {}
    for name, child in module.flax_tree().items():
        if isinstance(child, nn.Module):
            out.update(_layout(child, prefix + (name,)))
        else:
            out[prefix + (name,)] = (child, None)
    return out


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def load_jax_params(model, params):
    """Fill ``model`` from flax variables ``{"params": tree, ...}`` whose
    leaves are arrays (numpy, or anything ``np.asarray`` takes). Every
    other collection given (``"vq_stats"``) fills the modules'
    `flax_state` buffers of that name, cast to each buffer's dtype.

    Raises KeyError when a tree misses an entry of the model or holds one
    the model lacks, and ValueError on a shape mismatch. A lazy layer
    (in-features not yet known) takes its shape from the tree. Returns
    ``model``.
    """
    if not isinstance(params, Mapping) or "params" not in params:
        raise KeyError("expected flax variables of the form "
                       "{'params': {...}}")
    for collection, tree in params.items():
        if collection != "params":
            _load_state(model, collection, tree)
    given = dict(_flatten(params["params"]))
    want = _layout(model)
    missing = sorted("/".join(p) for p in set(want) - set(given))
    extra = sorted("/".join(p) for p in set(given) - set(want))
    if missing or extra:
        raise KeyError(f"flax tree does not match {type(model).__name__}: "
                       f"missing {missing}, extra {extra}")
    with torch.no_grad():
        for path, (param, perm) in want.items():
            value = np.asarray(given[path], dtype=np.float32)
            if perm is not None:
                value = value.transpose(perm)
            if isinstance(param, UninitializedParameter):
                param.materialize(value.shape)
            elif tuple(param.shape) != value.shape:
                raise ValueError(
                    f"{'/'.join(path)}: flax shape {value.shape} (axes "
                    f"permuted: {perm}) != port shape "
                    f"{tuple(param.shape)}")
            param.copy_(torch.tensor(value))
    for m in model.modules():  # lazy layers learn their sizes here
        if (isinstance(m, nn.Linear)
                and not isinstance(m.weight, UninitializedParameter)):
            m.out_features, m.in_features = m.weight.shape
    return model


def _load_state(model, collection, tree):
    given = dict(_flatten(tree))
    want = _layout(model, collection=collection)
    missing = sorted("/".join(p) for p in set(want) - set(given))
    extra = sorted("/".join(p) for p in set(given) - set(want))
    if missing or extra:
        raise KeyError(f"flax {collection!r} does not match "
                       f"{type(model).__name__}: missing {missing}, extra "
                       f"{extra}")
    with torch.no_grad():
        for path, (buf, _) in want.items():
            value = np.asarray(given[path])
            if tuple(buf.shape) != value.shape:
                raise ValueError(f"{collection}/{'/'.join(path)}: flax "
                                 f"shape {value.shape} != port shape "
                                 f"{tuple(buf.shape)}")
            buf.copy_(torch.tensor(value))
