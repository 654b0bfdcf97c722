"""Halo exchange: node-partitioned full-graph aggregation over processes.

Counterpart of `gammagl_tpu/parallel/halo.py`. Nodes are cut into
contiguous row blocks, one per part; each part owns the edges of its
destination rows, and the boundary ("halo") source rows it needs from its
peers arrive with ONE ``all_to_all`` a layer. After it the aggregation is
a local segment sum into the owned rows.

The JAX package runs the parts as the shards of one program over a device
mesh; the port runs one process per part under ``torch.distributed``
(`parallel.mesh.part_world`), and each process passes its own block. A
partition of one part runs in one process with no group and no exchange.

`build_halo_partition` is host numpy and gives the JAX package's fields
bit for bit:
  * each part's padded local edge list (sources remapped into
    ``[own block | halo buffer]``, pads with destination ``rows_per``,
    which the segment sum drops),
  * ``send_idx[q]``: which of its rows each peer q needs (padded).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gammagl_tpu_torch.ops.segment import segment_sum
from gammagl_tpu_torch.parallel.mesh import part_world
from gammagl_tpu_torch.parallel.partition import balance_permutation

__all__ = ["HaloPartition", "build_halo_partition", "make_halo_spmm",
           "reorder_bandwidth"]


class HaloPartition(NamedTuple):
    edge_index: np.ndarray   # (P, 2, E_max) local (src_local, dst_local)
    edge_weight: np.ndarray  # (P, E_max), 0 at pads
    send_idx: np.ndarray     # (P, P, H) local row ids to send to peer q
    num_parts: int
    rows_per: int            # owned rows per part (last block padded)
    halo_per_peer: int       # H
    num_nodes: int
    # balanced relabeling: new_id = node_inv[old_id]; per-node data is
    # reordered with x[node_perm] by `pad_nodes`/`shard_nodes`, results
    # un-permuted by `unpad_nodes`. None = natural order.
    node_perm: object = None
    node_inv: object = None

    @property
    def halo_total(self):
        return self.num_parts * self.halo_per_peer


def _round_up(x, m):
    return -(-x // m) * m


def _halo_sets(edge_index, num_nodes, num_parts, edge_weight=None,
               row_align=8):
    """The partition analysis shared with `halo_plan`.

    Returns (rows_per, H, part_edges, halo, send_idx):
      part_edges[p] = (sub (2, E_p) global ids, w_p, src_owner_p)
      halo[p][q]    = sorted global source ids part p needs from q
      send_idx      = (P, P, H) local row ids each OWNER sends to each peer
    """
    ei = np.asarray(edge_index)
    w = (np.asarray(edge_weight) if edge_weight is not None
         else np.ones(ei.shape[1], np.float32))
    rows_per = _round_up(-(-num_nodes // num_parts), row_align)
    owner_dst = np.minimum(ei[1] // rows_per, num_parts - 1)
    owner_src = np.minimum(ei[0] // rows_per, num_parts - 1)

    halo = [[np.empty(0, np.int64)] * num_parts for _ in range(num_parts)]
    part_edges = []
    for p in range(num_parts):
        mask = owner_dst == p
        sub = ei[:, mask]
        sub_src_owner = owner_src[mask]
        for q in range(num_parts):
            if q == p:
                continue
            halo[p][q] = np.unique(sub[0][sub_src_owner == q])
        part_edges.append((sub, w[mask], sub_src_owner))

    H = max([1] + [len(halo[p][q]) for p in range(num_parts)
                   for q in range(num_parts)])
    H = _round_up(H, 8)
    send_idx = np.zeros((num_parts, num_parts, H), np.int32)
    for p in range(num_parts):
        for q in range(num_parts):
            if q == p:
                continue
            # q must send part p the rows halo[p][q]: a SENDER-side record
            send_idx[q, p, :len(halo[p][q])] = halo[p][q] - q * rows_per
    return rows_per, H, part_edges, halo, send_idx


def _balanced_relabel(edge_index, num_nodes, num_parts):
    """(relabeled edge_index, perm, inv), or (edge_index, None, None) when
    the relabeling is the identity (one part, or a graph too small)."""
    ei = np.asarray(edge_index)
    if num_parts <= 1:
        return ei, None, None
    perm, inv = balance_permutation(ei, num_nodes, num_parts)
    if np.array_equal(perm, np.arange(num_nodes)):
        return ei, None, None
    return inv[ei], perm, inv


def build_halo_partition(edge_index, num_nodes, num_parts,
                         edge_weight=None, balance=True):
    """Contiguous node blocks; each edge goes to its destination's owner.

    ``balance`` (default) relabels nodes with `balance_permutation` so
    every part owns about as many edges; the permutation rides on the
    partition (`node_perm`/`node_inv`) and `shard_nodes` applies it.
    """
    if balance:
        ei_b, perm, inv = _balanced_relabel(edge_index, num_nodes,
                                            num_parts)
        if perm is not None:
            return build_halo_partition(
                ei_b, num_nodes, num_parts, edge_weight,
                balance=False)._replace(node_perm=perm, node_inv=inv)
        edge_index = ei_b
    rows_per, H, part_edges, halo, send_idx = _halo_sets(
        edge_index, num_nodes, num_parts, edge_weight)
    E_max = _round_up(max(1, max(pe[0].shape[1] for pe in part_edges)), 128)

    edge_out = np.zeros((num_parts, 2, E_max), np.int32)
    w_out = np.zeros((num_parts, E_max), np.float32)
    for p in range(num_parts):
        sub, sub_w, sub_src_owner = part_edges[p]
        E_p = sub.shape[1]
        # local source ids: own rows first, then the halo buffer laid out
        # [peer 0 | peer 1 | ...], each H wide (the own slot unused)
        src_local = np.empty(E_p, np.int64)
        own = sub_src_owner == p
        src_local[own] = sub[0][own] - p * rows_per
        for q in range(num_parts):
            if q == p:
                continue
            sel = sub_src_owner == q
            if not sel.any():
                continue
            pos = np.searchsorted(halo[p][q], sub[0][sel])
            src_local[sel] = rows_per + q * H + pos
        edge_out[p, 0, :E_p] = src_local
        edge_out[p, 1, :E_p] = sub[1] - p * rows_per
        edge_out[p, 1, E_p:] = rows_per  # pads: dropped by the sum
        w_out[p, :E_p] = sub_w
    return HaloPartition(edge_out, w_out, send_idx, num_parts, rows_per,
                         H, num_nodes)


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks, differentiable: its transpose
    is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=group)
        return recv

    @staticmethod
    def backward(ctx, g):
        return _Exchange.apply(g.contiguous(), ctx.group), None


def make_halo_spmm(part: HaloPartition, group=None):
    """The flat tier: ``spmm(x_blk) -> (rows_per, F)`` for this process's
    part, ``x_blk`` its own (rows_per, F) block.

    Gathers the rows each peer needs, exchanges them with one
    ``all_to_all_single`` (none with one part), and sums the weighted
    ``[own | halo]`` rows into the owned rows with `segment_sum`. The
    messages are ``x * w`` with w float32, so bf16 rows sum in float32 and
    the result is float32, as in the JAX tier. Differentiable through
    autograd (the exchange's transpose is an exchange). The JAX tier's
    local sum is XLA, so this tier runs no kernel of the port.
    """
    rank, nparts, group = part_world(part.num_parts, group)
    rows_per = part.rows_per
    arrays = (part.edge_index[rank, 0].astype(np.int64),
              part.edge_index[rank, 1].astype(np.int64),
              part.edge_weight[rank],
              part.send_idx[rank].reshape(-1).astype(np.int64))
    placed = {}

    def spmm(x_blk):
        if x_blk.dim() != 2 or x_blk.shape[0] != rows_per:
            raise ValueError(f"x_blk must be this part's ({rows_per}, F) "
                             f"block, got {tuple(x_blk.shape)}")
        dev = x_blk.device
        if dev not in placed:
            placed[dev] = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        src, dst, w, send_idx = placed[dev]
        table = x_blk
        if nparts > 1:
            recv = _Exchange.apply(x_blk[send_idx], group)
            table = torch.cat([x_blk, recv])
        return segment_sum(table[src] * w[:, None], dst, rows_per)

    return spmm


def reorder_bandwidth(edge_index, num_nodes):
    """Reverse Cuthill-McKee node reordering (scipy, ``symmetric_mode``):
    a banded adjacency after it.

    Returns (perm, inv) with new_id = inv[old_id]: relabel edges with
    ``inv[edge_index]`` and node rows with ``x[perm]``. ``perm`` is a
    contiguous copy (scipy returns a reversed view, which
    ``torch.from_numpy`` refuses).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ei = np.asarray(edge_index)
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(num_nodes, num_nodes)).tocsr()
    perm = np.ascontiguousarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_nodes)
    return perm, inv
