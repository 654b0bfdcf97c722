"""Train state and full checkpoints (counterpart of
`gammagl_tpu/train/state.py`).

The state is a model, its Adam optimizer and the step count.
``torch.optim.Adam(weight_decay=l2)`` adds ``l2 * param`` to the gradient
before the moments, which is the JAX package's
``optax.chain(add_decayed_weights(l2), adam(lr))`` (not AdamW). A
checkpoint holds the step, the parameters and the optimizer state, so
training resumes exactly.

A sharded checkpoint (`save_checkpoint_sharded`) is a directory written by
every process of a group: each process writes its own view of a tree of
tensors (its shards, and its copy of what is replicated) to its own file,
and process 0 writes the step file last. The JAX package writes an Orbax
checkpoint of global arrays; Orbax is a JAX library, so the port's format
is its own (ROADMAP C58).
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from gammagl_tpu_torch.parallel.mesh import world

__all__ = ["TrainState", "save_checkpoint", "load_checkpoint",
           "save_checkpoint_sharded", "load_checkpoint_sharded"]

# the file that makes a sharded checkpoint complete
STEP_FILE = "step.json"


class TrainState:
    """``model`` with ``Adam(lr, weight_decay=l2)`` over its parameters."""

    def __init__(self, model, lr, l2=0.0):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                          weight_decay=l2)
        self.step = 0

    def apply_gradients(self):
        """One optimizer step on the gradients in ``.grad``, then clear
        them."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def save_checkpoint(path, state):
    """Write step, parameters and optimizer state to one file."""
    torch.save({"step": state.step,
                "params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict()}, path)


def load_checkpoint(path, state):
    """Restore a checkpoint into ``state`` (same model and optimizer
    structure) and return it."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    return state


def _flatten(tree, prefix=()):
    """[(path, leaf)] of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten(v, prefix + (k,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, leaves) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return next(leaves)


def _shard_file(path, rank, size):
    return os.path.join(path, f"shard{rank:05d}-of-{size:05d}.pt")


def _write(obj, dest, write):
    """Write to a temporary name beside ``dest``, then rename it there."""
    tmp = f"{dest}.tmp{os.getpid()}"
    write(obj, tmp)
    os.replace(tmp, dest)


def _barrier(size, group):
    if size > 1:
        dist.barrier(group=group)


def save_checkpoint_sharded(path, tree, step=None, group=None):
    """Write ``tree`` (dicts, lists and tuples of tensors, numpy arrays and
    Python scalars) to the directory ``path`` from every process of
    ``group`` (None: the default group, or this process alone); every
    process calls it.

    Each process writes its own leaves, on the host, to its own file under
    a temporary name that it then renames into place; after a barrier,
    process 0 writes ``step.json`` (the step, the world size and the
    leaves' paths) the same way, and a last barrier returns once the
    checkpoint is whole. A directory without the step file is incomplete,
    and `load_checkpoint_sharded` refuses it; process 0 removes an older
    step file before anything is written, so an interrupted save never
    leaves a complete-looking mix."""
    rank, size, group = world(group)
    path = os.fspath(path)
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        if os.path.exists(os.path.join(path, STEP_FILE)):
            os.remove(os.path.join(path, STEP_FILE))
        for name in os.listdir(path):
            if name.startswith("shard") and not name.endswith(
                    f"-of-{size:05d}.pt"):
                os.remove(os.path.join(path, name))
    _barrier(size, group)
    flat = _flatten(tree)
    leaves = []
    for _, leaf in flat:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
        elif isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        leaves.append(leaf)
    _write(leaves, _shard_file(path, rank, size), torch.save)
    _barrier(size, group)
    if rank == 0:
        meta = {"step": 0 if step is None else int(step), "world_size": size,
                "paths": [[str(k) for k in p] for p, _ in flat]}

        def dump(obj, dest):
            with open(dest, "w") as f:
                json.dump(obj, f)

        _write(meta, os.path.join(path, STEP_FILE), dump)
    _barrier(size, group)


def load_checkpoint_sharded(path, template, group=None):
    """Read this process's leaves of a `save_checkpoint_sharded` directory
    into ``template``'s structure; returns ``(tree, step)``.

    Raises when the directory has no step file (incomplete), when it was
    written by another number of processes, or when a leaf's path, shape
    or dtype differs from the template's. Each tensor leaf is placed on
    the template leaf's device; a numpy template leaf comes back as a
    numpy array, a scalar as the saved scalar."""
    rank, size, _ = world(group)
    path = os.fspath(path)
    meta_path = os.path.join(path, STEP_FILE)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{path} holds no complete sharded "
                                f"checkpoint (no {STEP_FILE})")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta["world_size"] != size:
        raise ValueError(f"the checkpoint in {path} was written by "
                         f"{meta['world_size']} process(es); this group has "
                         f"{size}")
    flat = _flatten(template)
    paths = [[str(k) for k in p] for p, _ in flat]
    if paths != meta["paths"]:
        raise ValueError(f"the checkpoint's leaves {meta['paths']} are not "
                         f"the template's {paths}")
    saved = torch.load(_shard_file(path, rank, size), map_location="cpu",
                       weights_only=True)
    out = []
    for (p, want), got in zip(flat, saved):
        if isinstance(want, (torch.Tensor, np.ndarray)):
            w = torch.as_tensor(want) if isinstance(want, np.ndarray) \
                else want
            if not isinstance(got, torch.Tensor) or got.shape != w.shape \
                    or got.dtype != w.dtype:
                what = (f"{tuple(got.shape)} {got.dtype}"
                        if isinstance(got, torch.Tensor) else repr(got))
                raise ValueError(f"leaf {'/'.join(map(str, p))}: saved "
                                 f"{what}, the template has "
                                 f"{tuple(w.shape)} {w.dtype}")
            got = (got.numpy() if isinstance(want, np.ndarray)
                   else got.to(want.device))
        out.append(got)
    return _rebuild(template, iter(out)), int(meta["step"])
