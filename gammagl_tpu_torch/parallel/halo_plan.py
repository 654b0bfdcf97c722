"""The planned halo tier: overlapped, kernel-backed halo SpMM.

Counterpart of `gammagl_tpu/parallel/halo_plan.py`: the flat planned tier
over `parallel.halo`, and the two-level planned tier over
`parallel.hier_halo` (`PlannedHierHaloPartition`). Over the halo
partitions:

1. **Interior/boundary split.** Edges whose source a part owns
   ("interior") aggregate straight from its own block with no dependency
   on the exchange, so the ``all_to_all`` runs (``async_op=True``) while
   they do; only the boundary edges wait for the received rows.
2. **Kernels.** Each part's edges of each class are laid out as a
   `CSRPlan`, and the sums run on the CSR SpMM kernel: the interior chain
   block by block (block 0 writes ``out``, each later block adds into it
   through `spmm_csr_acc`), then the boundary class folds into the same
   ``out``.

The interior edges are cut by source row span (``num_src_blocks``,
`auto_src_blocks`) exactly as in the JAX package, so both packages see
the same blocks. On the TPU the cut keeps each gather under a footprint
cliff of its gather engine; on the card it is kept as the JAX package's
layout and measured, not needed.

Weights are fixed per graph and baked into the plans at build time (f32,
in each plan's CSR order). The backward is the same tier on the reversed
graph's partition (``transpose``): dx = A^T g runs through the kernels,
never through autograd of the gathers.

What the JAX tier has and this one leaves out, because they manage the
TPU and its compiler: the tile padding of `_pad_plans` (replaced by one
`CSRPlan` per part and class), ``pack_halves`` and the pre-gather
(``GGL_PACKED_HALO``; the kernel gathers its own rows in every dtype and
width), ``optimization_barrier`` (eager launches on one stream are
ordered), ``as_args`` and ``_zero_cotangents`` (the jit boundary), and
``interpret``.

The two-level tier splits each part's edges into three classes by the
table their source lies in: interior (the own block), intra (the rows of
the slice's peers, ``[0, D*H1)``) and inter (the table of other slices'
rows, ``[0, D*S*H2)``). Per part: both ``all_to_all`` start, the interior
class folds from the own block while they run, the intra class after the
dp exchange, and the inter class after the slice exchange and the
``all_gather`` over dp. The JAX tier's single interior class is kept (no
source blocks).
"""

from typing import NamedTuple

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda.segment_matmul import (_first_order_only,
                                                       build_csr_plan,
                                                       spmm_csr_acc,
                                                       spmm_csr_acc_reference)
from gammagl_tpu_torch.parallel.halo import _balanced_relabel, _halo_sets
from gammagl_tpu_torch.parallel.hier_halo import (HierHaloPartition,
                                                  _all_gather, _grid_arrays,
                                                  build_hier_halo_partition)
from gammagl_tpu_torch.parallel.mesh import hier_world, part_world

__all__ = ["PlannedHaloPartition", "build_halo_partition_planned",
           "make_halo_spmm_planned", "make_halo_spmm_planned_pair",
           "auto_src_blocks", "PlannedHierHaloPartition",
           "build_hier_halo_partition_planned",
           "make_hier_halo_spmm_planned",
           "make_hier_halo_spmm_planned_pair"]


class PlannedHaloPartition(NamedTuple):
    """Per-part interior and boundary plans.

    ``interior[b][p]`` is part p's `CSRPlan` of interior source block b:
    rows are p's own rows, sources block-local ids in ``src_spans[b]``
    (the kernel reads the slice ``x_blk[lo:hi]``); ``interior_w[b][p]``
    its float32 weights in the plan's CSR order. ``boundary[p]`` /
    ``boundary_w[p]``: sources index the received table ``[q*H + pos]``.
    The other fields are the JAX partition's, with the same values.
    """
    send_idx: np.ndarray     # (P, P, H) owner-side rows to send to peer
    interior: tuple
    interior_w: tuple
    boundary: tuple
    boundary_w: tuple
    num_parts: int
    rows_per: int
    halo_per_peer: int
    num_nodes: int
    R: int
    ET: int
    # the reversed graph's partition (same weights and labeling): dx
    transpose: object = None
    # per interior block (lo, hi) source rows; blocks of one span share it
    src_spans: tuple = ()
    # balanced relabeling (see halo.HaloPartition.node_perm)
    node_perm: object = None
    node_inv: object = None

    @property
    def nblocks(self):
        return -(-self.rows_per // self.R)


def _itemsize(dtype):
    """Bytes of one element of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def auto_src_blocks(rows_per, feat_dim, dtype=np.float32,
                    budget_bytes=90 * 2**20):
    """Source blocks that keep one interior gather's touched footprint
    under 90 MiB: the JAX package's rule, from its TPU's gather engine.
    ``dtype`` is a numpy or torch dtype."""
    return max(1, -(-rows_per * feat_dim * _itemsize(dtype)
                    // budget_bytes))


def _round8(x):
    return max(8, (x // 8) * 8)


def _src_block_spans(part_edges, num_parts, rows_per, B):
    """Source row spans that bound both each block's row span (at most
    ceil(rows_per / B), the uniform grid) and its interior edge mass
    (about total / B: boundaries at quantiles of the local source-row
    histogram); a span whose mass still passes the cap (one hub row can)
    is split into several chunk plans sharing the span.

    Returns (spans, chunks_per_span, cap); spans are (lo, hi) pairs shared
    by every part, on multiples of 8 rows.
    """
    if B <= 1 or rows_per <= 8:
        return [(0, rows_per)], [1], None
    hist = np.zeros(rows_per, np.int64)
    per_dev_total = np.zeros(num_parts, np.int64)
    for p in range(num_parts):
        sub, _, src_owner = part_edges[p]
        own = src_owner == p
        if own.any():
            hist += np.bincount(sub[0][own] - p * rows_per,
                                minlength=rows_per)[:rows_per]
            per_dev_total[p] = int(own.sum())
    cum = np.cumsum(hist)
    total = int(cum[-1])
    if total == 0:
        edge_bounds = np.empty(0, np.int64)
    else:
        targets = total * np.arange(1, B) / B
        edge_bounds = np.searchsorted(cum, targets)
    rows_blk = -(-rows_per // B)
    grid = np.arange(rows_blk, rows_per, rows_blk)
    bounds = np.union1d(edge_bounds, grid)
    bounds = np.unique(np.clip((bounds // 8) * 8, 0, rows_per))
    bounds = bounds[(bounds > 0) & (bounds < rows_per)]
    bounds = [0] + bounds.tolist() + [rows_per]
    spans = list(zip(bounds[:-1], bounds[1:]))
    # the chunking cap from the WORST part's interior mass, and the chunk
    # count of a span from its worst part (every part gets as many plans)
    worst_total = int(per_dev_total.max()) if num_parts else total
    cap = max(1, -(-worst_total // B))
    chunks = []
    for lo, hi in spans:
        worst = 0
        for p in range(num_parts):
            sub, _, src_owner = part_edges[p]
            own = src_owner == p
            s = sub[0][own] - p * rows_per
            worst = max(worst, int(((s >= lo) & (s < hi)).sum()))
        chunks.append(max(1, -(-worst // cap)))
    return spans, chunks, cap


def _plan_with_weights(src, dst, w, num_nodes, num_src):
    """A `CSRPlan` and its float32 weights in the plan's CSR order."""
    plan = build_csr_plan(src, dst, num_nodes, num_src=num_src)
    return plan, np.asarray(w, np.float32)[plan.perm]


def build_halo_partition_planned(edge_index, num_nodes, num_parts,
                                 edge_weight=None, R=256, ET=512,
                                 num_src_blocks=1, with_transpose=True,
                                 balance=True):
    """Contiguous node blocks and each part's interior and boundary plans.

    The partition analysis of `build_halo_partition` (`_halo_sets`), then
    each part's edges are split by source owner; interior edges by source
    span (``num_src_blocks``, helper `auto_src_blocks`), block-local
    source ids. ``R`` (clipped so a small part keeps one full row block)
    and ``ET`` are the JAX package's tile sizes, kept on the partition;
    they change no layout here. ``with_transpose`` attaches the reversed
    graph's partition for the backward; ``balance`` applies the
    in-degree-balanced relabeling (`node_perm`/`node_inv`, applied by
    `shard_nodes`), shared by the transpose.
    """
    if balance:
        ei_b, perm, inv = _balanced_relabel(edge_index, num_nodes,
                                            num_parts)
        if perm is not None:
            return build_halo_partition_planned(
                ei_b, num_nodes, num_parts, edge_weight, R=R, ET=ET,
                num_src_blocks=num_src_blocks,
                with_transpose=with_transpose,
                balance=False)._replace(node_perm=perm, node_inv=inv)
        edge_index = ei_b
    if with_transpose:
        ei = np.asarray(edge_index)
        part_t = build_halo_partition_planned(
            ei[[1, 0]], num_nodes, num_parts, edge_weight, R=R, ET=ET,
            num_src_blocks=num_src_blocks, with_transpose=False,
            balance=False)
        return build_halo_partition_planned(
            ei, num_nodes, num_parts, edge_weight, R=R, ET=ET,
            num_src_blocks=num_src_blocks,
            with_transpose=False, balance=False)._replace(transpose=part_t)
    rows_per, H, part_edges, halo, send_idx = _halo_sets(
        edge_index, num_nodes, num_parts, edge_weight)
    R = min(R, _round8(rows_per))
    spans, span_chunks, _ = _src_block_spans(part_edges, num_parts,
                                             rows_per,
                                             max(1, int(num_src_blocks)))
    blocks = [(lo, hi) for (lo, hi), K in zip(spans, span_chunks)
              for _ in range(K)]
    lows = np.asarray([lo for lo, _ in spans])

    interior = [[] for _ in blocks]
    boundary = []
    for p in range(num_parts):
        sub, sub_w, src_owner = part_edges[p]
        own = src_owner == p
        dst_local = sub[1] - p * rows_per
        src_own = sub[0][own] - p * rows_per
        dst_own = dst_local[own]
        w_own = sub_w[own]
        span_of = np.searchsorted(lows, src_own, side="right") - 1
        b = 0
        for s, ((lo, hi), K) in enumerate(zip(spans, span_chunks)):
            idx = np.nonzero(span_of == s)[0]
            sz = -(-len(idx) // K)
            for k in range(K):
                part_idx = idx[k * sz:(k + 1) * sz]
                interior[b].append(_plan_with_weights(
                    src_own[part_idx] - lo, dst_own[part_idx],
                    w_own[part_idx], rows_per, hi - lo))
                b += 1

        # boundary: sources index the received table [q*H + pos]
        bsel = ~own
        src_halo = np.zeros(int(bsel.sum()), np.int64)
        bsrc = sub[0][bsel]
        bowner = src_owner[bsel]
        for q in range(num_parts):
            if q == p:
                continue
            qm = bowner == q
            if qm.any():
                src_halo[qm] = q * H + np.searchsorted(halo[p][q], bsrc[qm])
        boundary.append(_plan_with_weights(src_halo, dst_local[bsel],
                                           sub_w[bsel], rows_per,
                                           num_parts * H))
    return PlannedHaloPartition(
        send_idx=send_idx,
        interior=tuple(tuple(pl for pl, _ in blk) for blk in interior),
        interior_w=tuple(tuple(w for _, w in blk) for blk in interior),
        boundary=tuple(pl for pl, _ in boundary),
        boundary_w=tuple(w for _, w in boundary),
        num_parts=num_parts, rows_per=rows_per, halo_per_peer=H,
        num_nodes=num_nodes, R=R, ET=ET,
        src_spans=tuple((int(lo), int(hi)) for lo, hi in blocks))


def _acc(kernel, x, w, plan, prev):
    """prev + A x on ``plan`` (``prev`` None: A x), in place in ``prev``
    on the kernel; ``kernel=False`` takes the plain version."""
    if kernel:
        return spmm_csr_acc(x, w, plan, prev=prev, weights_padded=True,
                            out=prev)
    return spmm_csr_acc_reference(x, w, plan, prev=prev, weights_padded=True)


class _Tier:
    """One direction of the planned tier on this process's part:
    ``tier(x_blk) -> (rows_per, F)`` of x's dtype, recording no autograd
    graph. ``kernel=False`` runs the plain versions instead of the
    kernels, on any device."""

    def __init__(self, part, group, kernel):
        self.rank, self.nparts, self.group = part_world(part.num_parts,
                                                        group)
        r = self.rank
        self.rows_per = part.rows_per
        self.blocks = [(lo, hi, blk[r], w[r]) for (lo, hi), blk, w in zip(
            part.src_spans, part.interior, part.interior_w)]
        self.boundary = (part.boundary[r], part.boundary_w[r])
        self.send_idx = part.send_idx[r].reshape(-1).astype(np.int64)
        self.kernel = kernel
        self._placed = {}

    def _weights(self, dev):
        if dev not in self._placed:
            self._placed[dev] = (
                [torch.from_numpy(w).to(dev) for *_, w in self.blocks],
                torch.from_numpy(self.boundary[1]).to(dev),
                torch.from_numpy(self.send_idx).to(dev))
        return self._placed[dev]

    @torch.no_grad()
    def __call__(self, x_blk):
        if x_blk.dim() != 2 or x_blk.shape[0] != self.rows_per:
            raise ValueError(f"x_blk must be this part's ({self.rows_per}, "
                             f"F) block, got {tuple(x_blk.shape)}")
        x_blk = x_blk.contiguous()
        w_in, w_bd, send_idx = self._weights(x_blk.device)
        work = None
        if self.nparts > 1:
            send = x_blk[send_idx]
            recv = torch.empty_like(send)
            work = torch.distributed.all_to_all_single(
                recv, send, group=self.group, async_op=True)
        # the interior chain needs nothing from the exchange: block 0
        # writes out, each later block adds into it in place. A later
        # block or the boundary without edges would only copy out to
        # itself, so it is not launched.
        out = None
        for (lo, hi, plan, _), w in zip(self.blocks, w_in):
            if out is None or plan.num_edges:
                out = _acc(self.kernel, x_blk[lo:hi], w, plan, out)
        if work is not None:
            work.wait()
            plan = self.boundary[0]
            if plan.num_edges:
                out = _acc(self.kernel, recv, w_bd, plan, out)
        return out


class _PlannedSpmm(torch.autograd.Function):
    """The tier's forward, with dx = the tier on the transpose partition."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        _first_order_only("the planned halo SpMM")
        if ctx.bwd is None:
            raise RuntimeError("the partition was built with "
                               "with_transpose=False: no backward")
        return ctx.bwd(g), None, None


def make_halo_spmm_planned(part: PlannedHaloPartition, group=None,
                           kernel=True):
    """``spmm(x_blk) -> (rows_per, F)``: the planned tier on this process's
    part, ``x_blk`` its own (rows_per, F) float32 or bfloat16 block; the
    result has x's dtype.

    Per part: start the halo ``all_to_all_single`` (async; none with one
    part), run the interior chain from the own block while it is in
    flight, wait, and fold the boundary class in. Each kernel call sums in
    float32 and rounds once to x's dtype, so the chain rounds once per
    block (the JAX tier adds bf16 partials). Differentiable once: dx runs
    the same tier on ``part.transpose`` (kernel launches on the card);
    ``create_graph=True`` raises. ``kernel=False`` asks for the plain
    versions explicitly, the JAX parameter's counterpart.
    """
    fwd = _Tier(part, group, kernel)
    bwd = (None if part.transpose is None
           else _Tier(part.transpose._replace(transpose=None), group, kernel))

    def spmm(x_blk):
        return _PlannedSpmm.apply(x_blk, fwd, bwd)

    return spmm


def make_halo_spmm_planned_pair(part: PlannedHaloPartition, group=None):
    """``(spmm, spmm_t)``: both directions of the planned tier as separate
    callables, neither differentiable (a staged training loop owns the
    chain rule): ``spmm(x_blk)`` is A x, ``spmm_t(g_blk)`` is A^T g, on the
    kernels."""
    if part.transpose is None:
        raise ValueError("make_halo_spmm_planned_pair needs a partition "
                         "built with with_transpose=True")
    return (_Tier(part, group, True),
            _Tier(part.transpose._replace(transpose=None), group, True))


class PlannedHierHaloPartition(NamedTuple):
    """The two-level partition's three edge classes, one `CSRPlan` a part
    and class, over the part's own rows.

    ``interior[r]`` reads the own block, ``intra[r]`` the received intra
    rows ``[0, D*H1)``, ``inter[r]`` the inter table ``[0, D*S*H2)`` of
    part r = s*D + d; ``*_w[r]`` are their float32 weights in the plan's
    CSR order. ``base`` is the `HierHaloPartition` (its senders' tables
    and traffic counters); ``transpose`` the reversed graph's partition
    (dx).
    """
    base: HierHaloPartition
    interior: tuple
    interior_w: tuple
    intra: tuple
    intra_w: tuple
    inter: tuple
    inter_w: tuple
    transpose: object = None
    node_perm: object = None
    node_inv: object = None

    @property
    def num_slices(self):
        return self.base.num_slices

    @property
    def dp_per_slice(self):
        return self.base.dp_per_slice

    @property
    def num_parts(self):
        return self.base.num_parts

    @property
    def rows_per(self):
        return self.base.rows_per

    @property
    def num_nodes(self):
        return self.base.num_nodes


def build_hier_halo_partition_planned(edge_index, num_nodes, num_slices,
                                      dp_per_slice, edge_weight=None,
                                      R=256, ET=512, with_transpose=True,
                                      balance=True):
    """`build_hier_halo_partition`'s analysis, then each part's edges
    split by source table (own / intra / inter) into one plan a class.

    ``balance`` (default) applies the in-degree-balanced relabeling; the
    permutation rides on the outer partition's ``node_perm`` /
    ``node_inv``. ``with_transpose`` attaches the reversed graph's
    partition for the backward. ``R`` and ``ET``, the JAX package's tile
    sizes, are accepted and ignored: the plans have no tiles.
    """
    if balance:
        ei_b, perm, inv = _balanced_relabel(edge_index, num_nodes,
                                            int(num_slices)
                                            * int(dp_per_slice))
        if perm is not None:
            return build_hier_halo_partition_planned(
                ei_b, num_nodes, num_slices, dp_per_slice, edge_weight,
                with_transpose=with_transpose,
                balance=False)._replace(node_perm=perm, node_inv=inv)
        edge_index = ei_b
    if with_transpose:
        ei = np.asarray(edge_index)
        part_t = build_hier_halo_partition_planned(
            ei[[1, 0]], num_nodes, num_slices, dp_per_slice, edge_weight,
            with_transpose=False, balance=False)
        return build_hier_halo_partition_planned(
            ei, num_nodes, num_slices, dp_per_slice, edge_weight,
            with_transpose=False,
            balance=False)._replace(transpose=part_t)

    base = build_hier_halo_partition(edge_index, num_nodes, num_slices,
                                     dp_per_slice, edge_weight,
                                     balance=False)
    S, D = base.num_slices, base.dp_per_slice
    rows_per, H1, H2 = base.rows_per, base.h_intra, base.h_inter
    classes = ((0, rows_per), (rows_per, D * H1),
               (rows_per + D * H1, D * S * H2))
    plans = [[] for _ in classes]
    for s in range(S):
        for d in range(D):
            src = base.edge_index[s, d, 0].astype(np.int64)
            dst = base.edge_index[s, d, 1].astype(np.int64)
            w = base.edge_weight[s, d]
            valid = dst < rows_per  # pads carry dst = rows_per
            src, dst, w = src[valid], dst[valid], w[valid]
            for c, (lo, nsrc) in enumerate(classes):
                m = (src >= lo) & (src < lo + nsrc)
                plans[c].append(_plan_with_weights(src[m] - lo, dst[m],
                                                   w[m], rows_per, nsrc))
    (interior, intra, inter) = (tuple(pl for pl, _ in c) for c in plans)
    (interior_w, intra_w, inter_w) = (tuple(w for _, w in c) for c in plans)
    return PlannedHierHaloPartition(
        base=base, interior=interior, interior_w=interior_w, intra=intra,
        intra_w=intra_w, inter=inter, inter_w=inter_w)


class _HierTier:
    """One direction of the planned two-level tier on this process's
    part: ``tier(x_blk) -> (rows_per, F)`` of x's dtype, recording no
    autograd graph."""

    def __init__(self, part, grid, kernel):
        self.grid = grid
        r = grid.rank
        self.rows_per = part.rows_per
        self.classes = tuple((plans[r], w[r]) for plans, w in (
            (part.interior, part.interior_w), (part.intra, part.intra_w),
            (part.inter, part.inter_w)))
        self.sends = _grid_arrays(part.base, grid)
        self.kernel = kernel
        self._placed = {}

    def _weights(self, dev):
        if dev not in self._placed:
            self._placed[dev] = (
                [torch.from_numpy(w).to(dev) for _, w in self.classes],
                [torch.from_numpy(a).to(dev) for a in self.sends])
        return self._placed[dev]

    @torch.no_grad()
    def __call__(self, x_blk):
        if x_blk.dim() != 2 or x_blk.shape[0] != self.rows_per:
            raise ValueError(f"x_blk must be this part's ({self.rows_per}, "
                             f"F) block, got {tuple(x_blk.shape)}")
        x_blk = x_blk.contiguous()
        ws, (send1, send2) = self._weights(x_blk.device)
        grid = self.grid
        S, D = grid.num_slices, grid.dp_per_slice
        # both exchanges start before any sum; an axis of one process
        # sends its chunk to itself, so it runs no collective
        recv1 = x_blk[send1]
        recv2 = x_blk[send2]
        work1 = work2 = None
        if D > 1:
            send, recv1 = recv1, torch.empty_like(recv1)
            work1 = torch.distributed.all_to_all_single(
                recv1, send, group=grid.dp, async_op=True)
        if S > 1:
            send, recv2 = recv2, torch.empty_like(recv2)
            work2 = torch.distributed.all_to_all_single(
                recv2, send, group=grid.slice, async_op=True)
        (p_in, _), (p_ia, _), (p_ir, _) = self.classes
        # the interior class writes out; a later class without edges
        # would only copy out to itself, so it is not launched
        out = _acc(self.kernel, x_blk, ws[0], p_in, None)
        if work1 is not None:
            work1.wait()
        if p_ia.num_edges:
            out = _acc(self.kernel, recv1, ws[1], p_ia, out)
        if work2 is not None:
            work2.wait()
        table2 = _all_gather(recv2, grid.dp, D) if D > 1 else recv2
        if p_ir.num_edges:
            out = _acc(self.kernel, table2, ws[2], p_ir, out)
        return out


def _hier_tiers(part, groups, kernel):
    grid = hier_world(part.num_slices, part.dp_per_slice, groups)
    fwd = _HierTier(part, grid, kernel)
    bwd = (None if part.transpose is None
           else _HierTier(part.transpose, grid, kernel))
    return fwd, bwd


def make_hier_halo_spmm_planned(part: PlannedHierHaloPartition, groups=None,
                                kernel=True):
    """``spmm(x_blk) -> (rows_per, F)``: the planned two-level tier on this
    process's part, ``x_blk`` its own (rows_per, F) float32 or bfloat16
    block; the result has x's dtype.

    ``groups`` is this process's `HierGrid` (None: `hier_world` over the
    default group). Per part: start the intra (dp) and inter (slice)
    ``all_to_all`` (async), fold the interior class from the own block
    while they run (the first launch writes ``out``), wait for the intra
    rows and fold their class into ``out`` (`spmm_csr_acc`), wait for the
    inter rows, ``all_gather`` them over dp, and fold the inter class. A
    class without edges is not launched. Each class rounds once to x's
    dtype (the JAX tier adds bf16 partials). Differentiable once: dx is
    the same tier on ``part.transpose``. ``kernel=False`` takes the plain
    versions.
    """
    fwd, bwd = _hier_tiers(part, groups, kernel)

    def spmm(x_blk):
        return _PlannedSpmm.apply(x_blk, fwd, bwd)

    return spmm


def make_hier_halo_spmm_planned_pair(part: PlannedHierHaloPartition,
                                     groups=None):
    """``(spmm, spmm_t)``: A x and A^T g of the planned two-level tier as
    separate callables on the kernels, neither differentiable (the staged
    recipe owns the chain rule)."""
    if part.transpose is None:
        raise ValueError("make_hier_halo_spmm_planned_pair needs a "
                         "partition built with with_transpose=True")
    return _hier_tiers(part, groups, True)
