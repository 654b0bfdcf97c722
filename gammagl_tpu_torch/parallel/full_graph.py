"""Full-graph GCN training on a halo partition, counterpart of
`gammagl_tpu/parallel/full_graph.py`.

Nodes stay partitioned for the whole run: features, activations, labels
and logits are each process's own (rows_per, ...) block; only the
per-layer halo exchange moves boundary rows between processes. Dense
layers, the loss and the optimizer are plain PyTorch on each block, and
the replicated parameters' gradients are summed over the processes with
``all_reduce`` (in the JAX package GSPMD sums them implicitly).

Recipes, as in the JAX package:

* `make_partitioned_gcn_train`: an L-layer GCN differentiated by autograd
  through the tier (the planned tier's backward is the tier on the
  transpose partition); ``remat`` recomputes each layer in the backward
  (`torch.utils.checkpoint`), trading one more halo SpMM a layer for
  holding one layer's activations.
* `make_partitioned_gcn_train_staged`: the same model with the chain rule
  written out layer by layer (the JAX package's per-layer jits): the
  forward, the loss head, then per layer the matmul gradients and dx =
  A^T da on the planned tier's transpose direction. Unlike the JAX
  recipe, each layer's aggregate ``a_i = A h_i`` is kept from the forward
  rather than recomputed: the card holds it easily (0.57 GB a layer at
  1.1M rows, bf16), and it saves one SpMM a layer.
* `sign_precompute`: K sweeps of the tier, [X, AX, ..., A^K X], for a
  graph-free model.
* `make_partitioned_gat_train`: an L-layer GAT over an `AttnHaloPartition`
  on the flash kernels (`parallel.halo_attention`), autograd through it.

Every GCN recipe runs on the four tiers: flat and planned, each on a
partition of P parts (``group``: the process group) or on a two-level
partition (``group``: its `HierGrid`, or the group to build one over);
the loss and the gradients are summed over every part.

The builders return ``(params, opt_state, train_step, eval_logits)``
with the JAX step signature ``train_step(params, opt_state, x, y, mask) ->
(params, opt_state, loss)``: params are a dict of float32 ``w{i}`` (fan_in,
fan_out) and ``b{i}`` tensors, drawn as in the JAX package from the same
seed, and opt_state is `torch.optim.AdamW` over them (optax.adamw's
update: eps 1e-8, bias correction, decoupled decay). Both are updated in
place and returned. ``train_step.loss_and_grads(params, x, y, mask)``
gives the loss and the summed gradients without the update.
`estimate_hbm_gb` sizes a configuration before anything is allocated.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gammagl_tpu_torch.parallel.halo import HaloPartition, make_halo_spmm
from gammagl_tpu_torch.parallel.halo_plan import (
    PlannedHaloPartition, PlannedHierHaloPartition, _itemsize,
    make_halo_spmm_planned, make_halo_spmm_planned_pair,
    make_hier_halo_spmm_planned, make_hier_halo_spmm_planned_pair)
from gammagl_tpu_torch.parallel.hier_halo import (HierHaloPartition,
                                                  make_hier_halo_spmm)
from gammagl_tpu_torch.parallel.mesh import hier_world, part_world
from gammagl_tpu_torch.utils.device import resolve_device, to_device

__all__ = ["pad_nodes", "unpad_nodes", "shard_nodes", "sign_precompute",
           "make_partitioned_gcn_train", "make_partitioned_gcn_train_staged",
           "make_partitioned_gat_train", "estimate_hbm_gb",
           "params_from_jax"]

# the JAX recipe's loss chunking on one part: f32 logits are formed CH
# rows at a time once a part holds more than CHUNK_ROWS rows
CH, CHUNK_ROWS = 131_072, 262_144


def _world(part, group):
    """(nparts, the group the parts' sums run over, the tier's group): a
    two-level partition's tier takes its `HierGrid` (``group`` may be one,
    else it is built over ``group``), and the sums run over the whole
    grid."""
    if isinstance(part, (HierHaloPartition, PlannedHierHaloPartition)):
        grid = hier_world(part.num_slices, part.dp_per_slice, group)
        return part.num_parts, grid.group, grid
    _, nparts, group = part_world(part.num_parts, group)
    return nparts, group, group


def _make_spmm(part, group=None):
    """The halo SpMM tier by partition type: the flat tier
    (`HaloPartition`), the planned tier (`PlannedHaloPartition`), the
    two-level tier (`HierHaloPartition`) or the planned two-level tier
    (`PlannedHierHaloPartition`); ``group`` is the grid of the two-level
    tiers."""
    if isinstance(part, PlannedHierHaloPartition):
        return make_hier_halo_spmm_planned(part, group)
    if isinstance(part, HierHaloPartition):
        return make_hier_halo_spmm(part, group)
    if isinstance(part, PlannedHaloPartition):
        return make_halo_spmm_planned(part, group)
    if isinstance(part, HaloPartition):
        return make_halo_spmm(part, group)
    raise TypeError(f"no halo tier for {type(part).__name__}")


def pad_nodes(arr, part, fill=0):
    """Pad a global per-node numpy array (N, ...) to the partition's
    (P*rows_per, ...), in the partition's node order (``arr[node_perm]``
    first when it carries a balanced relabeling), so callers keep their
    natural order."""
    arr = np.asarray(arr)
    perm = getattr(part, "node_perm", None)
    if perm is not None:
        arr = arr[perm]
    total = part.num_parts * part.rows_per
    pad = [(0, total - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def unpad_nodes(out, part):
    """Inverse of `pad_nodes` for global per-node results (P*rows_per, ...):
    strip the padding and undo the relabeling; natural-order numpy (N,
    ...). A tensor is brought to the host first."""
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    out = np.asarray(out)[:part.num_nodes]
    inv = getattr(part, "node_inv", None)
    return out if inv is None else out[inv]


def shard_nodes(arr, part, rank=None, device=None, dtype=None, fill=0):
    """This process's (rows_per, ...) block of a global per-node array,
    padded and reordered as `pad_nodes` pads and reorders the whole, as a
    tensor on ``device`` (None: the card) in ``dtype`` (None: the array's
    own). ``rank`` defaults to this process's part (0 without a process
    group). Only the block's rows are read, so a memory-mapped array
    (the OGB loader's) is never copied whole on the host."""
    if rank is None:
        rank = part_world(part.num_parts)[0]
    rows = part.rows_per
    arr = np.asarray(arr)
    perm = getattr(part, "node_perm", None)
    n = arr.shape[0] if perm is None else perm.shape[0]
    take = slice(min(rank * rows, n), min((rank + 1) * rows, n))
    blk = arr[take] if perm is None else arr[perm[take]]
    if blk.shape[0] < rows:
        pad = [(0, rows - blk.shape[0])] + [(0, 0)] * (blk.ndim - 1)
        blk = np.pad(blk, pad, constant_values=fill)
    return to_device(blk, device, dtype)


@torch.no_grad()
def sign_precompute(part, x_blk, num_hops, store_dtype=torch.bfloat16,
                    group=None):
    """K sweeps of the halo SpMM: [X, AX, ..., A^K X] for this process's
    block, each cast to ``store_dtype`` (the reference's SIGN transform,
    `gammagl/transforms/sign.py:7`, takes dense powers; here each sweep is
    one exchange and a local sum, and the graph can be dropped after)."""
    spmm = _make_spmm(part, _world(part, group)[2])
    ops = [x_blk.to(store_dtype)]
    h = x_blk
    for _ in range(num_hops):
        h = spmm(h)
        ops.append(h.to(store_dtype))
    return ops


def _glorot(rng, fan_in, fan_out):
    s = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-s, s, (fan_in, fan_out)).astype(np.float32)


def _init_params(seed, dims, device):
    """The JAX recipe's parameters: glorot kernels drawn from
    ``default_rng(seed)`` in layer order, zero biases."""
    rng = np.random.default_rng(seed)
    L = len(dims) - 1
    tree = {f"w{i}": _glorot(rng, dims[i], dims[i + 1]) for i in range(L)}
    tree.update({f"b{i}": np.zeros(dims[i + 1], np.float32)
                 for i in range(L)})
    return params_from_jax(tree, device)


def params_from_jax(tree, device=None):
    """The JAX recipes' parameter tree ``{"w{i}": (fan_in, fan_out),
    "b{i}": (fan_out,)}`` (numpy or array-likes) as the port's: float32
    leaf tensors on ``device`` (None: the card) that require grad, in the
    same layout (``h @ w + b``)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True) for k, v in tree.items()}


def _adamw(params, learning_rate, weight_decay):
    return torch.optim.AdamW(list(params.values()), lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


class _MaskedCEChunked(torch.autograd.Function):
    """Mean masked softmax cross-entropy with the float32 logits formed
    ``ch`` rows at a time (the JAX recipe's `_masked_ce_chunked`: at a
    papers100M shard the full float32 logits would cost gigabytes). The
    backward redoes each chunk's softmax from the saved compute-dtype
    logits, and carries the mask's gradient too: dL/dm_i = (ls_i - L) /
    sum(m), the -L term dropped when the max(sum(m), 1) clamp holds."""

    @staticmethod
    def forward(ctx, logits, y, m, ch):
        tot = logits.new_zeros((), dtype=torch.float32)
        for i in range(0, logits.shape[0], ch):
            ls = F.cross_entropy(logits[i:i + ch].float(), y[i:i + ch],
                                 reduction="none")
            tot = tot + (ls * m[i:i + ch]).sum()
        out = tot / m.sum().clamp_min(1.0)
        ctx.save_for_backward(logits, y, m, out)
        ctx.ch = ch
        return out

    @staticmethod
    def backward(ctx, g):
        logits, y, m, out = ctx.saved_tensors
        ch = ctx.ch
        msum = m.sum()
        scale = g / msum.clamp_min(1.0)
        sub = torch.where(msum >= 1.0, out, 0.0)
        dl = torch.empty_like(logits)
        dm = torch.empty_like(m)
        for i in range(0, logits.shape[0], ch):
            with torch.enable_grad():
                lg = logits[i:i + ch].detach().requires_grad_()
                ls = F.cross_entropy(lg.float(), y[i:i + ch],
                                     reduction="none")
                dl[i:i + ch], = torch.autograd.grad(
                    ls, lg, grad_outputs=m[i:i + ch] * scale)
            dm[i:i + ch] = ((ls.detach() - sub) * scale).to(m.dtype)
        return dl, None, dm, None


def jax_labels(y, num_classes):
    """Integer labels as JAX's cross-entropy reads them
    (`optax.softmax_cross_entropy_with_integer_labels`): a negative label
    counts from the last class. OGB marks a row without a label -1 (the
    papers twin's ``--data-root``); such rows are masked out, and this
    keeps `F.cross_entropy` from refusing them."""
    y = y.long()
    return torch.where(y < 0, y + num_classes, y)


def _masked_ce_chunked(logits, y, m, ch=CH):
    """`_MaskedCEChunked` as a function: (logits (n, C), y (n,) integer, m
    (n,) float) -> the mean masked cross-entropy."""
    return _MaskedCEChunked.apply(logits, jax_labels(y, logits.shape[1]), m,
                                  ch)


def _loss(logits, y, mask, nparts, group):
    """The global mean masked cross-entropy's share of this part: the
    part's masked sum over the mask sum of every part, so the parts'
    shares (and their gradients) add up to the JAX recipe's loss."""
    m = mask.float()
    y = jax_labels(y, logits.shape[1])
    if nparts == 1 and logits.shape[0] > CHUNK_ROWS:
        return _masked_ce_chunked(logits, y, m)
    msum = m.sum()
    if nparts > 1:
        msum = msum.detach().clone()
        dist.all_reduce(msum, group=group)
    ls = F.cross_entropy(logits.float(), y, reduction="none")
    return (ls * m).sum() / msum.clamp_min(1.0)


def _check_params(params, opt_state):
    if [id(t) for t in params.values()] != [
            id(t) for g in opt_state.param_groups for t in g["params"]]:
        raise ValueError("params are not the tensors opt_state updates: "
                         "load new values into the builder's params "
                         "(copy_) instead of passing another dict")


def _sum_over_parts(loss, grads, nparts, group):
    """The loss and the gradients summed over the parts."""
    if nparts > 1:
        dist.all_reduce(loss, group=group)
        for g in grads.values():
            dist.all_reduce(g, group=group)
    return loss, grads


def _step_fns(loss_and_grads):
    """train_step over ``loss_and_grads``: the AdamW step on the summed
    gradients; ``train_step.loss_and_grads`` is kept on it."""

    def train_step(params, opt_state, x, y, mask):
        loss, grads = loss_and_grads(params, x, y, mask)
        for k, t in params.items():
            t.grad = grads[k]
        opt_state.step()
        opt_state.zero_grad(set_to_none=True)
        return params, opt_state, loss

    train_step.loss_and_grads = loss_and_grads
    return train_step


def make_partitioned_gcn_train(part, feat_dim, hidden_dim, num_classes,
                               num_layers=2, compute_dtype=torch.bfloat16,
                               remat=True, learning_rate=1e-2,
                               weight_decay=0.0, seed=0, group=None,
                               device=None):
    """Build ``(params, opt_state, train_step, eval_logits)`` for an
    L-layer GCN over a halo partition, autograd through the tier.

    ``x`` is this process's (rows_per, F) block, ``y`` and ``mask`` its
    (rows_per,) blocks (mask 0 on pads and rows not trained on;
    `shard_nodes`). Activations run in ``compute_dtype``, parameters and
    the optimizer in float32. ``eval_logits(params, x)`` gives float32
    (rows_per, C) logits. ``device`` None means the card.
    """
    device = resolve_device(device)
    nparts, group, tier_group = _world(part, group)
    spmm = _make_spmm(part, tier_group)
    dims = [feat_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
    params = _init_params(seed, dims, device)
    opt_state = _adamw(params, learning_rate, weight_decay)
    cd = compute_dtype

    def layer(h, w, b):
        # the tier returns x's dtype (the planned tier) or float32 (the
        # flat tier, f32 weights): cast back down for the matmul
        return spmm(h).to(cd) @ w.to(cd) + b.to(cd)

    def forward(p, x):
        h = x.to(cd)
        for i in range(num_layers):
            args = (h, p[f"w{i}"], p[f"b{i}"])
            h = (checkpoint(layer, *args, use_reentrant=False) if remat
                 else layer(*args))
            if i < num_layers - 1:
                h = torch.relu(h)
        return h

    def loss_and_grads(p, x, y, mask):
        _check_params(p, opt_state)
        with torch.enable_grad():
            loss = _loss(forward(p, x), y, mask, nparts, group)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        return _sum_over_parts(loss.detach(), grads, nparts, group)

    @torch.no_grad()
    def eval_logits(p, x):
        return forward(p, x).float()

    return params, opt_state, _step_fns(loss_and_grads), eval_logits


def make_partitioned_gcn_train_staged(part, feat_dim, hidden_dim,
                                      num_classes, num_layers=3,
                                      compute_dtype=torch.bfloat16,
                                      learning_rate=1e-2, weight_decay=0.0,
                                      seed=0, group=None, device=None):
    """Layer-staged variant of `make_partitioned_gcn_train`: the same
    model, parameters and step, with the chain rule written out.

        forward_i : h_i -> a_i = A h_i, h_{i+1} = relu(a_i W_i + b_i)
        head      : logits, y, mask -> loss, dlogits (float32 CE)
        backward_i: dh -> dW_i = a_i^T dh (a bf16 product summed in
                    float32), db_i, dh_i = A^T (dh W_i^T)

    On a `PlannedHaloPartition` or a `PlannedHierHaloPartition` A^T runs
    the pair's ``spmm_t`` (the kernels on the transpose partition, which
    the partition must carry); on the flat tiers it is the tier's
    autograd transpose. Same signature and returns as the monolithic
    builder.
    """
    device = resolve_device(device)
    nparts, group, tier_group = _world(part, group)
    if isinstance(part, PlannedHaloPartition):
        spmm, spmm_t = make_halo_spmm_planned_pair(part, tier_group)
    elif isinstance(part, PlannedHierHaloPartition):
        spmm, spmm_t = make_hier_halo_spmm_planned_pair(part, tier_group)
    else:
        spmm = _make_spmm(part, tier_group)

        def spmm_t(da):
            with torch.enable_grad():
                z = torch.zeros_like(da, requires_grad=True)
                out = spmm(z)
                return torch.autograd.grad(out, z, da.to(out.dtype))[0]
    dims = [feat_dim] + [hidden_dim] * (num_layers - 1) + [num_classes]
    params = _init_params(seed, dims, device)
    opt_state = _adamw(params, learning_rate, weight_decay)
    cd = compute_dtype

    def fwd_layer(w, b, h, relu):
        a = spmm(h.to(cd)).to(cd)
        out = a @ w.to(cd) + b.to(cd)
        return (torch.relu(out) if relu else out), a

    def head(logits, y, mask):
        with torch.enable_grad():
            lg = logits.detach().requires_grad_()
            loss = _loss(lg, y, mask, nparts, group)
            dl, = torch.autograd.grad(loss, lg)
        return loss.detach(), dl

    @torch.no_grad()
    def loss_and_grads(p, x, y, mask):
        _check_params(p, opt_state)
        hs, aggs = [x], []
        for i in range(num_layers):
            h, a = fwd_layer(p[f"w{i}"], p[f"b{i}"], hs[-1],
                             i < num_layers - 1)
            hs.append(h)
            aggs.append(a)
        loss, dh = head(hs[-1], y, mask)
        hs[-1] = None
        grads = {}
        for i in reversed(range(num_layers)):
            if i < num_layers - 1:
                dh = dh * (hs[i + 1] > 0).to(dh.dtype)
            hs[i + 1] = None
            grads[f"w{i}"] = (aggs[i].t() @ dh).float()
            grads[f"b{i}"] = dh.float().sum(0)
            aggs[i] = None
            if i:
                dh = spmm_t((dh @ p[f"w{i}"].to(cd).t()).to(cd)).to(cd)
        return _sum_over_parts(loss, grads, nparts, group)

    @torch.no_grad()
    def eval_logits(p, x):
        h = x
        for i in range(num_layers):
            h, _ = fwd_layer(p[f"w{i}"], p[f"b{i}"], h, i < num_layers - 1)
        return h.float()

    return params, opt_state, _step_fns(loss_and_grads), eval_logits


def make_partitioned_gat_train(part, feat_dim, hidden_dim, num_classes,
                               heads=4, num_layers=2,
                               compute_dtype=torch.bfloat16, remat=True,
                               learning_rate=1e-2, weight_decay=0.0,
                               negative_slope=0.2, seed=0, group=None,
                               device=None):
    """Build ``(params, opt_state, train_step, eval_logits)`` for an
    L-layer GAT over an `AttnHaloPartition` (the reference's GATModel,
    `gammagl/models/gat.py:10`: heads concatenated on hidden layers and
    averaged on the output layer), with the GCN recipes' signature.

    ``hidden_dim`` is per head; hidden activations are (rows_per,
    heads*hidden_dim). Each layer: one projection matmul on the part's
    block, one halo exchange, the flash kernels over the part's plan
    (`make_partitioned_gat_layer`), ELU on hidden layers. Parameters
    ``w{i}``, ``as{i}``, ``ad{i}`` (heads, out), ``b{i}`` are drawn as in
    the JAX recipe from ``default_rng(seed)``, in that order a layer;
    AdamW, and the masked mean cross-entropy over all parts. ``remat``
    recomputes each layer in the backward (`torch.utils.checkpoint`: its
    exchange and flash forward run again). ``device`` None means the card.
    """
    from gammagl_tpu_torch.parallel.halo_attention import (
        AttnHaloPartition, make_partitioned_gat_layer)
    if not isinstance(part, AttnHaloPartition):
        raise TypeError(f"make_partitioned_gat_train needs an "
                        f"AttnHaloPartition, got {type(part).__name__}")
    device = resolve_device(device)
    _, nparts, group = part_world(part.num_parts, group)
    attn = make_partitioned_gat_layer(part, heads, group=group,
                                      negative_slope=negative_slope)
    rng = np.random.default_rng(seed)
    dims_in = [feat_dim] + [heads * hidden_dim] * (num_layers - 1)
    dims_out = [hidden_dim] * (num_layers - 1) + [num_classes]
    tree = {}
    for i in range(num_layers):
        tree[f"w{i}"] = _glorot(rng, dims_in[i], heads * dims_out[i])
        tree[f"as{i}"] = _glorot(rng, heads, dims_out[i])
        tree[f"ad{i}"] = _glorot(rng, heads, dims_out[i])
        tree[f"b{i}"] = np.zeros(
            dims_out[i] * (heads if i < num_layers - 1 else 1), np.float32)
    params = params_from_jax(tree, device)
    opt_state = _adamw(params, learning_rate, weight_decay)
    cd = compute_dtype

    def layer(h, w, a_s, a_d, b, last):
        h = attn(h @ w.to(cd), a_s, a_d).to(cd)
        if not last:
            return F.elu(h + b.to(cd))
        # the output layer averages the heads (the reference's concat=False)
        return h.view(h.shape[0], heads, -1).mean(1) + b.to(cd)

    def forward(p, x):
        h = x.to(cd)
        for i in range(num_layers):
            args = (h, p[f"w{i}"], p[f"as{i}"], p[f"ad{i}"], p[f"b{i}"],
                    i == num_layers - 1)
            h = (checkpoint(layer, *args, use_reentrant=False) if remat
                 else layer(*args))
        return h

    def loss_and_grads(p, x, y, mask):
        _check_params(p, opt_state)
        with torch.enable_grad():
            loss = _loss(forward(p, x), y, mask, nparts, group)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        return _sum_over_parts(loss.detach(), grads, nparts, group)

    @torch.no_grad()
    def eval_logits(p, x):
        return forward(p, x).float()

    return params, opt_state, _step_fns(loss_and_grads), eval_logits


def estimate_hbm_gb(num_nodes, feat_dim, hidden_dim, num_layers,
                    num_parts, avg_degree, compute_dtype=torch.bfloat16,
                    remat=True):
    """Rough device memory a part of `make_partitioned_gcn_train` holds
    (features, live activations, the halo buffer, the edge shard), in GB:
    the JAX package's formula, for a numpy or torch ``compute_dtype``."""
    rows = -(-num_nodes // num_parts)
    bytes_c = _itemsize(compute_dtype)
    feats = rows * feat_dim * bytes_c
    live = 2 if remat else num_layers + 1
    acts = live * rows * hidden_dim * bytes_c
    halo = rows * max(feat_dim, hidden_dim) * bytes_c
    edges = (num_nodes * avg_degree // num_parts) * (2 * 4 + 4)
    return (feats + acts + halo + edges) / 1e9
