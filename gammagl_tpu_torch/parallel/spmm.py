"""Edge-sharded SpMM over a process group, counterpart of
`gammagl_tpu/parallel/spmm.py`.

Each process owns one edge shard of an `EdgePartition` and holds the whole
feature matrix. The JAX package sums each shard's messages with XLA's
segment sum inside ``shard_map`` and adds the partials with ``psum``; here
each shard's sum runs the CSR SpMM kernel (`spmm_csr`, PERF.md row 1) on a
`CSRPlan` of the shard, built once on the host, and one ``all_reduce``
over the group adds the partials. With one process there is no
collective.

Gradients follow ``jax.grad`` of the JAX function. The replicated ``x``
enters through `_copy_to_group` (identity forward, ``all_reduce`` of the
gradient backward), so ``dx = sum_p A_p^T g`` is whole on every process;
the output leaves through `_reduce_from_group` (``all_reduce`` forward,
identity backward), so a loss that every process computes from the same
output is counted once. A shard's weights get their gradient on their
owner only.

The plan of an edge array is kept with the array it was built from,
matched by identity (and a tensor's version counter): pass the same
array on every call, as a training loop does, and the host builds it
once. An array changed in place without a new version (a numpy array)
is not noticed.
"""

import numpy as np
import torch
import torch.distributed as dist

from gammagl_tpu_torch.ops.cuda.segment_matmul import (build_csr_plan,
                                                        spmm_csr)
from gammagl_tpu_torch.parallel.mesh import world

__all__ = ["sharded_spmm", "make_sharded_spmm"]


class _CopyToGroup(torch.autograd.Function):
    """A tensor every process holds whole: identity forward, the gradient
    summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """The processes' partials summed over the group forward; the
    gradient of the sum passed through unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _copy_to_group(x, group, size):
    return x if size == 1 else _CopyToGroup.apply(x, group)


def _reduce_from_group(x, group, size):
    return x if size == 1 else _ReduceFromGroup.apply(x, group)


class _PlanCache:
    """Host-built values keyed by the arrays they were built from: each
    array's identity and, for a tensor, its version counter. The arrays are
    held with the value, so an id is not reused while the entry lives; the
    newest ``size`` entries are kept."""

    def __init__(self, build, size=4):
        self._build = build
        self._size = size
        self._entries = []

    def get(self, arrays, *args):
        key = tuple((id(a), getattr(a, "_version", None)) for a in arrays)
        key = key + args
        for k, _, value in self._entries:
            if k == key:
                return value
        value = self._build(*arrays, *args)
        self._entries = (self._entries + [(key, arrays, value)])[
            -self._size:]
        return value


def _host(a):
    """A tensor as a numpy array on the host; anything else as it is."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _edge_arrays(*arrays):
    """Host int64 copies of edge arrays (numpy or tensors)."""
    return tuple(np.asarray(_host(a)).astype(np.int64) for a in arrays)


def _coo_plan(edge_index, num_nodes, num_src):
    """(plan, pos): a `CSRPlan` of the edges whose destination lies in
    [0, num_nodes) (the JAX segment sum drops the others, the shards' pads
    among them), sources clipped into [0, num_src) as JAX's ``take(...,
    mode="clip")`` reads them; ``pos[i]`` is the position in the given
    edge array of the plan's i-th CSR edge, to carry weights."""
    src, dst = _edge_arrays(edge_index[0], edge_index[1])
    keep = np.nonzero((dst >= 0) & (dst < num_nodes))[0]
    plan = build_csr_plan(np.clip(src[keep], 0, num_src - 1), dst[keep],
                          num_nodes, num_src=num_src)
    return plan, {"pos": keep[plan.perm]}


def _placed(entry, key, device):
    """``entry[key]`` as an int64 tensor on ``device``, copied once."""
    slot = (key, device)
    if slot not in entry:
        entry[slot] = torch.from_numpy(entry[key]).to(device)
    return entry[slot]


def _csr_weights(w, entry, device):
    """Weights in the given edge order as float32 in the plan's CSR order
    (differentiable: a weight the plan drops gets a zero gradient)."""
    return w.float()[_placed(entry, "pos", device)]


def _own_shard(a, rank, nparts, what):
    """Row ``rank`` of a partition's (P, ...) stack, P the group's size."""
    if a.shape[0] != nparts:
        raise ValueError(f"{what} of shape {tuple(a.shape)}: expected the "
                         f"({nparts}, ...) stack of the group's shards")
    return a[rank]


def make_sharded_spmm(num_nodes, group=None):
    """The edge-sharded SpMM of this process: ``spmm(ei_shards, w_shards,
    x) -> (num_nodes, F)`` on every process of ``group`` (None: the
    default group, or one process without one).

    ei_shards : the partition's (P, 2, E_shard) stack (P the group's
        size); this process sums row ``rank``, and drops edges with ``dst
        == num_nodes`` (the pads).
    w_shards  : the (P, E_shard) weights (numpy arrays are copied to x's
        device).
    x         : (N, F), the same on every process.

    The result is float32 for bf16 ``x`` (the messages are ``x * w`` with
    w float32, as in JAX). On the card the shard's sum is one
    `spmm_csr` launch (one more for ``dx``); on the CPU its plain version.
    """
    rank, size, group = world(group)
    cache = _PlanCache(lambda stack, n_src: _coo_plan(
        _own_shard(stack, rank, size, "ei_shards"), num_nodes, n_src))

    def spmm(ei_shards, w_shards, x):
        ei = _own_shard(ei_shards, rank, size, "ei_shards")
        w = w_shards
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.asarray(w))
        w = _own_shard(w, rank, size, "w_shards").to(x.device)
        plan, entry = cache.get((ei_shards,), x.shape[0])
        if w.shape[0] != ei.shape[1]:
            raise ValueError(f"{w.shape[0]} weights for {ei.shape[1]} edges")
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = _copy_to_group(x, group, size)
        part = spmm_csr(x, _csr_weights(w, entry, x.device), plan,
                        weights_padded=True)
        return _reduce_from_group(part, group, size)

    return spmm


def sharded_spmm(ei_shards, w_shards, x, num_nodes, group=None):
    """One call of `make_sharded_spmm` (a training loop builds it once, so
    the shard's plan is built once)."""
    return make_sharded_spmm(num_nodes, group)(ei_shards, w_shards, x)
