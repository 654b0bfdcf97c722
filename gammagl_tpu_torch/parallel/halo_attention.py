"""Partitioned graph attention: GAT layers over a halo partition.

Counterpart of `gammagl_tpu/parallel/halo_attention.py`. Edges live with
their destination's owner, so the edge softmax, a reduction over each
destination's incoming edges, is local to a part; only source features
cross between processes, with one ``all_to_all`` a layer as in the halo
tiers.

Per part and layer:
  1. exchange the halo rows of the projected multi-head features;
  2. the per-node score halves ``a_src . h`` over the ``[own | halo]``
     table and ``a_dst . h`` over the own rows, in float32;
  3. the fused attention kernel (`flash_gat_attention`: LeakyReLU,
     softmax per destination and the weighted sum of all heads in one
     launch, its backward in one more) over one `CSRPlan` of the part's
     edges, destinations its own rows, sources the table's rows.

The JAX layer computes the softmax in XLA and aggregates each head with
its segment-matmul kernel, over one tiled plan a part; the port computes
the same function on the flash kernels. The gradient of the rows a part
sent goes back through the exchange's transpose, and is summed into the
owner's rows with `spmm_csr` on a scatter plan built once from
``send_idx`` (a row sent to several peers sums in one fixed order, so a
step repeats bit for bit on the card).
"""

from typing import NamedTuple

import numpy as np
import torch

from gammagl_tpu_torch.ops.cuda.flash_attention import flash_gat_attention
from gammagl_tpu_torch.ops.cuda.segment_matmul import (_first_order_only,
                                                       build_csr_plan,
                                                       spmm_csr)
from gammagl_tpu_torch.parallel.halo import _Exchange, _halo_sets
from gammagl_tpu_torch.parallel.mesh import part_world

__all__ = ["AttnHaloPartition", "build_halo_partition_attn",
           "make_partitioned_gat_layer"]


class AttnHaloPartition(NamedTuple):
    """One plan a part over the ``[own | halo]`` table.

    ``plans[p]`` has p's own rows as destinations and sources in
    ``[0, rows_per + P*H)``: own rows first, then the halo buffer laid out
    ``[peer 0 | peer 1 | ...]``, each H wide (with one part, only the own
    rows). ``send_idx`` (P, P, H) is the JAX partition's;
    ``send_count[q, p]`` says how many of ``send_idx[q, p]`` are real
    (the rest is padding). Attention weights are not baked in: they are
    computed each step.
    """
    send_idx: np.ndarray   # (P, P, H) owner-side rows to send to peer
    send_count: np.ndarray  # (P, P) real rows of send_idx[q, p]
    plans: tuple
    num_parts: int
    rows_per: int
    halo_per_peer: int
    num_nodes: int


def build_halo_partition_attn(edge_index, num_nodes, num_parts, R=256,
                              ET=512):
    """The halo partition (`halo._halo_sets`, no relabeling, as in the JAX
    package) and each part's plan over its ``[own | halo]`` table. ``R``
    and ``ET``, the JAX package's tile sizes, are accepted and ignored:
    the plan has no tiles."""
    rows_per, H, part_edges, halo, send_idx = _halo_sets(
        edge_index, num_nodes, num_parts)
    num_src = rows_per + (num_parts * H if num_parts > 1 else 0)
    send_count = np.zeros((num_parts, num_parts), np.int64)
    plans = []
    for p in range(num_parts):
        sub, _, src_owner = part_edges[p]
        src_local = np.empty(sub.shape[1], np.int64)
        own = src_owner == p
        src_local[own] = sub[0][own] - p * rows_per
        for q in range(num_parts):
            if q == p:
                continue
            send_count[q, p] = len(halo[p][q])
            sel = src_owner == q
            if sel.any():
                pos = np.searchsorted(halo[p][q], sub[0][sel])
                src_local[sel] = rows_per + q * H + pos
        plans.append(build_csr_plan(src_local, sub[1] - p * rows_per,
                                    rows_per, num_src=num_src))
    return AttnHaloPartition(send_idx=send_idx, send_count=send_count,
                             plans=tuple(plans), num_parts=num_parts,
                             rows_per=rows_per, halo_per_peer=H,
                             num_nodes=num_nodes)


class _SendRows(torch.autograd.Function):
    """x[idx] for the exchange; the backward sums each sent row's
    cotangent into its owner row with `spmm_csr` on ``scatter`` (rows:
    the part's rows, sources: the send buffer's real rows), not with an
    accumulating index_put."""

    @staticmethod
    def forward(ctx, x, idx, scatter):
        ctx.scatter = scatter
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        _first_order_only("the partitioned GAT layer's exchange")
        return spmm_csr(g.contiguous(), None, ctx.scatter), None, None


def _scatter_plan(part, rank):
    """The plan that sums the send buffer's real rows into their owner
    rows: destination ``send_idx[rank, q, i]`` for i below
    ``send_count[rank, q]``, source the buffer position ``q*H + i``."""
    H = part.halo_per_peer
    idx = part.send_idx[rank].reshape(-1).astype(np.int64)
    real = (np.arange(H)[None, :]
            < part.send_count[rank][:, None]).reshape(-1)
    pos = np.nonzero(real)[0]
    return build_csr_plan(pos, idx[real], part.rows_per,
                          num_src=part.num_parts * H)


def make_partitioned_gat_layer(part: AttnHaloPartition, num_heads,
                               group=None, negative_slope=0.2):
    """GAT attention over the partition (the reference's semantics,
    `gammagl/layers/conv/gat_conv.py:7`: score LeakyReLU(a_src . h_s +
    a_dst . h_d), softmax over each destination's edges, weighted sum).

    Returns ``layer(h_blk, a_src, a_dst) -> (rows_per, H*Fh)``, with
    ``h_blk`` this process's block of the projected features (rows_per,
    H*Fh) in float32 or bfloat16, and ``a_src`` / ``a_dst`` the (H, Fh)
    attention vectors; the result has h's dtype, a row without edges
    gives 0. Concatenating or averaging the heads and the bias are the
    caller's. Differentiable once in all three arguments: the forward is
    one launch of the flash forward on the card, the backward one of its
    backward, and `spmm_csr` launches that bring the gradients back to
    the source rows.
    """
    rank, nparts, group = part_world(part.num_parts, group)
    rows_per, heads = part.rows_per, int(num_heads)
    plan = part.plans[rank]
    idx = part.send_idx[rank].reshape(-1).astype(np.int64)
    scatter = _scatter_plan(part, rank) if nparts > 1 else None
    placed = {}

    def layer(h_blk, a_src, a_dst):
        if (h_blk.dim() != 2 or h_blk.shape[0] != rows_per
                or h_blk.shape[1] % heads):
            raise ValueError(f"h_blk must be this part's ({rows_per}, "
                             f"{heads}*Fh) block, got {tuple(h_blk.shape)}")
        table = h_blk
        if nparts > 1:
            dev = h_blk.device
            if dev not in placed:
                placed[dev] = torch.from_numpy(idx).to(dev)
            recv = _Exchange.apply(_SendRows.apply(h_blk, placed[dev],
                                                   scatter), group)
            table = torch.cat([h_blk, recv])
        fh = h_blk.shape[1] // heads
        t3 = table.view(-1, heads, fh).float()
        s_src = (t3 * a_src.float()).sum(-1)
        s_dst = (t3[:rows_per] * a_dst.float()).sum(-1)
        out = flash_gat_attention(s_src, s_dst, table, plan,
                                  negative_slope)
        return out.reshape(rows_per, heads * fh)

    return layer
