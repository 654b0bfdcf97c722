"""Pipeline, feature-sharded and relation-expert execution over a process
group, counterpart of `gammagl_tpu/parallel/strategies.py`.

The JAX package writes each strategy as a ``shard_map`` over a named mesh
axis; here one process owns one slot of the axis, and the collectives run
over its ``torch.distributed`` group (`parallel.mesh.world`):

- `pipeline_apply`: GPipe over layers. Stage s (process s) owns layer s's
  weights; microbatches stream stage to stage through a ring shift, in the
  classic ``num_micro + S - 1`` steps.
- `make_feature_sharded_spmm`: each process holds a block of the feature
  columns; the SpMM is independent per column, so it needs no collective.
- `relation_expert_spmm`: expert parallelism for relational models (RGCN):
  each process owns ``ceil(R / P)`` relation matrices; its edges' messages
  are summed into the destinations and one ``all_reduce`` adds the
  processes' partials.

The JAX package's sums are XLA segment sums; the port's run the CSR SpMM
kernel (`spmm_csr`, PERF.md row 1) on plans built once on the host.
Gradients are those of ``jax.grad`` of the JAX functions: a replicated
input's gradient is summed over the group, the summed output's is passed
through (`parallel.spmm`'s pair), and each process's own weights get
their gradient on it alone.
"""

import numpy as np
import torch
import torch.distributed as dist

from gammagl_tpu_torch.ops.cuda.segment_matmul import (build_csr_plan,
                                                        spmm_csr)
from gammagl_tpu_torch.parallel.mesh import world
from gammagl_tpu_torch.parallel.spmm import (_PlanCache, _coo_plan,
                                             _copy_to_group, _csr_weights,
                                             _edge_arrays,
                                             _reduce_from_group)
from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["pipeline_apply", "make_pipeline_apply",
           "make_feature_sharded_spmm", "relation_expert_spmm",
           "make_relation_expert_spmm", "shard_pipeline_params",
           "shard_expert_weights"]


def shard_pipeline_params(stage_params, group=None, device=None):
    """This process's stage of ``stage_params``, a tree whose leaves have
    the number of stages (the group's size) as their leading dim: each
    leaf's slice ``[rank]`` on ``device`` (None: the card). A leaf that
    requires grad keeps its graph, so its other stages' slices get zero
    gradients here."""
    from gammagl_tpu_torch.serve import _tree_map
    rank, size, _ = world(group)
    device = resolve_device(device)

    def take(a):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        if a.shape[0] != size:
            raise ValueError(f"a stage parameter of {a.shape[0]} stages for "
                             f"a pipeline of {size} processes")
        return a[rank].to(device)

    return _tree_map(take, stage_params)


class _RingShift(torch.autograd.Function):
    """Each process's tensor to the next (the last's to the first), by one
    ``all_to_all_single`` in which a process sends to its successor only;
    its transpose is the shift back."""

    @staticmethod
    def forward(ctx, h, group, step):
        ctx.group, ctx.step = group, step
        return _shift(h, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.step), None, None


def _shift(h, group, step):
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    n = h.numel()
    send, recv = [0] * size, [0] * size
    send[(rank + step) % size] = n
    recv[(rank - step) % size] = n
    out = torch.empty_like(h, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out.view(-1), h.contiguous().view(-1),
                           output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return out


def make_pipeline_apply(stage_fn, num_micro, group=None):
    """The differentiable GPipe forward of this process's stage:
    ``run(params, x_micro) -> (num_micro, B, F)``, the last stage's
    outputs, on every process.

    ``params`` is this process's stage (`shard_pipeline_params`),
    ``x_micro`` the (num_micro, B, F) microbatches, the same on every
    process. Every process runs all ``num_micro + S - 1`` steps and masks
    what it does not own, as the JAX schedule does: stage 0 takes
    microbatch t (the last again past the end), the others the activation
    their predecessor shifted to them, and the last stage's output of step
    t is microbatch ``t - S + 1``. So every process builds the same graph
    and issues the same collectives in the same order, forward and
    backward; activation gradients stream back through the shifts'
    transposes."""
    rank, S, group = world(group)
    steps = num_micro + S - 1

    def run(params, x_micro):
        xm = _copy_to_group(x_micro, group, S)
        first = torch.tensor(rank == 0, device=xm.device)
        last = torch.tensor(rank == S - 1, device=xm.device)
        buf = torch.zeros_like(xm[0])
        outs = []
        for t in range(steps):
            h = torch.where(first, xm[min(t, num_micro - 1)], buf)
            h = stage_fn(params, h)
            if t >= S - 1:
                outs.append(torch.where(last, h, torch.zeros_like(h)))
            if S > 1 and t < steps - 1:
                buf = _RingShift.apply(h, group, 1)
        return _reduce_from_group(torch.stack(outs), group, S)

    return run


def pipeline_apply(stage_fn, stage_params, x_micro, group=None,
                   device=None):
    """GPipe forward in one call: `shard_pipeline_params`, then
    `make_pipeline_apply`'s run on ``x_micro`` (moved to ``device``).

    stage_fn : (params_s, h) -> h, one stage (same shape in and out)
    stage_params : a tree whose leaves lead with the number of stages
    x_micro : (num_micro, B, F) microbatches
    Returns the (num_micro, B, F) outputs of the last stage."""
    device = resolve_device(device)
    params = shard_pipeline_params(stage_params, group, device)
    xm = torch.as_tensor(np.asarray(x_micro)) if not isinstance(
        x_micro, torch.Tensor) else x_micro
    run = make_pipeline_apply(stage_fn, xm.shape[0], group)
    return run(params, xm.to(device))


def make_feature_sharded_spmm(num_nodes, group=None):
    """SpMM of a block of the feature columns: ``run(ei, w, x_shard) ->
    (num_nodes, F_shard)``, ``x_shard`` this process's (N, F / P) block
    of the columns and ``ei`` (2, E), ``w`` (E,) or None the whole graph's
    edges, the same on every process of ``group``. No collective: each
    column's sum is independent. One `spmm_csr` launch on the plan of
    ``ei`` (built on the first call with that array, then kept); ``w``
    float32 makes a bf16 block's result float32, as in JAX."""
    world(group)
    cache = _PlanCache(lambda ei, n_src: _coo_plan(ei, num_nodes, n_src))

    def run(ei, w, x_shard):
        plan, entry = cache.get((ei,), x_shard.shape[0])
        if w is None:
            return spmm_csr(x_shard, None, plan)
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.asarray(w))
        w = w.to(x_shard.device)
        x_shard = x_shard.to(torch.promote_types(x_shard.dtype, w.dtype))
        return spmm_csr(x_shard, _csr_weights(w, entry, x_shard.device),
                        plan, weights_padded=True)

    return run


def shard_expert_weights(weights, group=None, device=None):
    """This process's block of the relation weights (R, F_in, F_out):
    ``per = ceil(R / P)`` relations from ``rank * per``, on ``device``
    (None: the card), the relations past R zeros. Relation r belongs to
    process ``r // per``. Returns (per, F_in, F_out)."""
    rank, size, _ = world(group)
    device = resolve_device(device)
    w = weights if isinstance(weights, torch.Tensor) else torch.as_tensor(
        np.asarray(weights))
    per = -(-w.shape[0] // size)
    blk = w[rank * per:(rank + 1) * per]
    if blk.shape[0] < per:
        blk = torch.cat([blk, blk.new_zeros((per - blk.shape[0],)
                                            + tuple(w.shape[1:]))])
    return blk.to(device)


def _expert_plan(ei, et, num_nodes, num_src, per, rank):
    """The plan of this process's relations: an edge of relation r with
    ``rank * per <= r < (rank + 1) * per`` and a destination in [0,
    num_nodes) reads row ``(r - rank * per) * num_src + src`` of the
    (per * num_src, F_out) table of transformed rows; other processes'
    edges, the padding relations and dropped destinations are left
    out."""
    src, dst, rel = _edge_arrays(ei[0], ei[1], et)
    local = rel - rank * per
    keep = (local >= 0) & (local < per) & (dst >= 0) & (dst < num_nodes)
    row = local[keep] * num_src + np.clip(src[keep], 0, num_src - 1)
    return build_csr_plan(row, dst[keep], num_nodes, num_src=per * num_src)


def make_relation_expert_spmm(num_nodes, group=None):
    """The expert-parallel relational SpMM: ``run(ei, et, x, w_local) ->
    (num_nodes, F_out)`` on every process, ``w_local`` this process's
    (per, F_in, F_out) block (`shard_expert_weights`), ``ei`` (2, E),
    ``et`` (E,) and ``x`` (N, F_in) the same everywhere.

    JAX gathers one (F_in, F_out) matrix an edge and contracts it. The
    port computes the same sum as the dense transforms ``x @ W_r`` of its
    ``per`` relations (`torch.matmul`: the JAX product is XLA, not a Pallas
    kernel), one (per * N, F_out) table, and one `spmm_csr` launch on the
    plan of its edges (built once for an (ei, et) pair), then one
    ``all_reduce``. Differentiable in x (its gradient summed over the
    group) and in w_local (kept on its owner; a padding block's is zero)."""
    rank, size, group = world(group)
    cache = _PlanCache(lambda ei, et, n_src, per: _expert_plan(
        ei, et, num_nodes, n_src, per, rank))

    def run(ei, et, x, w_local):
        per, f_in, f_out = w_local.shape
        n_src = x.shape[0]
        plan = cache.get((ei, et), n_src, per)
        dt = torch.promote_types(x.dtype, w_local.dtype)
        x = _copy_to_group(x.to(dt), group, size)
        table = torch.matmul(x.unsqueeze(0), w_local.to(dt))
        part = spmm_csr(table.reshape(per * n_src, f_out), None, plan)
        return _reduce_from_group(part, group, size)

    return run


def relation_expert_spmm(edge_index, edge_type, x, weights, num_nodes,
                         group=None, device=None):
    """Relation-typed transform and sum with the relation weights (R,
    F_in, F_out) spread over ``group`` in one call: `shard_expert_weights`
    on ``device`` (None: the card), then `make_relation_expert_spmm`."""
    device = resolve_device(device)
    w = shard_expert_weights(weights, group, device)

    def put(a):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        return a.to(device)

    run = make_relation_expert_spmm(num_nodes, group)
    return run(put(edge_index), put(edge_type), put(x), w)
