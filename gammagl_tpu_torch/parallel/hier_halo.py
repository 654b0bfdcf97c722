"""Two-level halo exchange over a slice x dp process grid.

Counterpart of `gammagl_tpu/parallel/hier_halo.py`. The flat tier
(`parallel.halo`) moves every boundary row with one ``all_to_all`` over
all parts, so a row that k parts of another slice need crosses the slow
link between slices k times. Here the parts form an S x D grid
(`parallel.mesh.hier_world`: S slices of D processes, slice-major), nodes
are cut slice-major into contiguous blocks, and each layer's exchange has
three steps:

  1. **intra**: ``all_to_all`` over ``dp``: the halo rows of peers in the
     same slice, the flat scheme within a slice;
  2. **inter**: ``all_to_all`` over ``slice``: the rows any part of
     another slice needs, each sent once per consumer slice by the owner,
     so the traffic between slices is spread over the D processes;
  3. **redistribute**: ``all_gather`` over ``dp`` of the received inter
     rows, so every part of a slice holds the same ``(D, S, H2)`` table.

Each part's edges are remapped on the host so their sources index the
concatenated ``[own rows | intra halo | inter halo]`` table; the sum is
then a local segment sum into the owned rows (pads dropped), as in
`halo.make_halo_spmm`. Like the JAX tier, it runs no kernel of the port;
the planned two-level tier of `parallel.halo_plan` runs the same
partition on the CSR kernels.

`build_hier_halo_partition` is host numpy and gives the JAX package's
fields bit for bit. `traffic_report` counts the bytes a layer moves: the
JAX package's names ``dcn`` (the link between slices) and ``ici`` (the
links within a slice) are kept.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gammagl_tpu_torch.ops.segment import segment_sum
from gammagl_tpu_torch.parallel.halo import _Exchange, _balanced_relabel
from gammagl_tpu_torch.parallel.mesh import hier_world

__all__ = ["HierHaloPartition", "build_hier_halo_partition",
           "make_hier_halo_spmm", "traffic_report"]


def _round_up(x, m):
    return -(-x // m) * m


class HierHaloPartition(NamedTuple):
    edge_index: np.ndarray   # (S, D, 2, E_max) local (src_local, dst_local)
    edge_weight: np.ndarray  # (S, D, E_max), 0 at pads
    send_intra: np.ndarray   # (S, D, D, H1) own-row ids for dp-peer q
    send_inter: np.ndarray   # (S, D, S, H2) own-row ids for consumer slice t
    num_slices: int          # S
    dp_per_slice: int        # D
    rows_per: int            # owned rows per part
    h_intra: int             # H1
    h_inter: int             # H2
    num_nodes: int
    # row counts for traffic_report (valid, unpadded)
    inter_rows: int          # sum over (s, t, d) of |R[s][t][d]|
    inter_rows_flat: int     # what a flat all_to_all sends between slices
    intra_rows: int
    # balanced relabeling (see halo.HaloPartition.node_perm)
    node_perm: object = None
    node_inv: object = None

    @property
    def num_parts(self):
        return self.num_slices * self.dp_per_slice


def build_hier_halo_partition(edge_index, num_nodes, num_slices,
                              dp_per_slice, edge_weight=None,
                              balance=True):
    """Slice-major contiguous node blocks; each edge goes to its
    destination's owner.

    Part ``(s, d)`` owns global rows ``[(s*D + d)*rows_per, ...)``. Source
    ids in each part's edge list are remapped to the local table
    ``[0, rows_per)`` own | ``rows_per + q*H1 + i`` intra (dp peer q) |
    ``rows_per + D*H1 + (d_owner*S + s)*H2 + i`` inter (slice s, owner d).

    ``balance`` (default) applies the in-degree-balanced relabeling over
    the S*D owner blocks (see `halo.build_halo_partition`).
    """
    S, D = int(num_slices), int(dp_per_slice)
    nparts = S * D
    if balance:
        ei_b, perm, inv = _balanced_relabel(edge_index, num_nodes, nparts)
        if perm is not None:
            return build_hier_halo_partition(
                ei_b, num_nodes, num_slices, dp_per_slice, edge_weight,
                balance=False)._replace(node_perm=perm, node_inv=inv)
        edge_index = ei_b
    ei = np.asarray(edge_index)
    w = (np.asarray(edge_weight) if edge_weight is not None
         else np.ones(ei.shape[1], np.float32))
    rows_per = _round_up(-(-num_nodes // nparts), 8)
    owner_dst = np.minimum(ei[1] // rows_per, nparts - 1)
    owner_src = np.minimum(ei[0] // rows_per, nparts - 1)

    # per consumer part p: its edges and intra-slice halo sets; per
    # (producer slice s, consumer slice t): the slice-deduplicated inter
    # sets, split by the owner's dp index d
    part_edges = [None] * nparts
    halo_intra = [[np.empty(0, np.int64)] * D for _ in range(nparts)]
    inter = [[[np.empty(0, np.int64)] * D for _ in range(S)]
             for _ in range(S)]  # inter[s][t][d]
    inter_rows_flat = 0
    for t in range(S):
        slice_remote = [[] for _ in range(S)]  # global src ids by producer
        for dc in range(D):
            p = t * D + dc
            mask = owner_dst == p
            sub = ei[:, mask]
            sub_owner = owner_src[mask]
            part_edges[p] = (sub, w[mask], sub_owner)
            for g in np.unique(sub_owner):
                g = int(g)
                s, d = g // D, g % D
                ids = np.unique(sub[0][sub_owner == g])
                if s == t:
                    if d != dc:
                        halo_intra[p][d] = ids
                else:
                    slice_remote[s].append(ids)
                    inter_rows_flat += len(ids)  # the flat scheme: per part
        for s in range(S):
            if s == t or not slice_remote[s]:
                continue
            ids = np.unique(np.concatenate(slice_remote[s]))
            own = ids // rows_per % D  # dp index of the owner
            for d in range(D):
                inter[s][t][d] = ids[own == d]

    H1 = max([1] + [len(h) for hs in halo_intra for h in hs])
    H1 = _round_up(H1, 8)
    H2 = max([1] + [len(inter[s][t][d]) for s in range(S)
                    for t in range(S) for d in range(D)])
    H2 = _round_up(H2, 8)
    E_max = _round_up(max(1, max(pe[0].shape[1] for pe in part_edges)), 128)

    edge_out = np.zeros((S, D, 2, E_max), np.int32)
    w_out = np.zeros((S, D, E_max), np.float32)
    send_intra = np.zeros((S, D, D, H1), np.int32)
    send_inter = np.zeros((S, D, S, H2), np.int32)
    intra_rows = 0
    inter_rows = 0

    # the senders' tables
    for s in range(S):
        for t in range(S):
            if s == t:
                continue
            for d in range(D):
                ids = inter[s][t][d]
                inter_rows += len(ids)
                base = (s * D + d) * rows_per
                send_inter[s, d, t, :len(ids)] = ids - base

    for t in range(S):
        for dc in range(D):
            p = t * D + dc
            sub, sub_w, sub_owner = part_edges[p]
            E_p = sub.shape[1]
            src_local = np.empty(E_p, np.int64)
            for g in np.unique(sub_owner):
                g = int(g)
                s, d = g // D, g % D
                sel = sub_owner == g
                if g == p:
                    src_local[sel] = sub[0][sel] - g * rows_per
                elif s == t:
                    ids = halo_intra[p][d]
                    intra_rows += len(ids)
                    pos = np.searchsorted(ids, sub[0][sel])
                    src_local[sel] = rows_per + d * H1 + pos
                    # dp peer d sends those rows to dc
                    send_intra[t, d, dc, :len(ids)] = ids - g * rows_per
                else:
                    ids = inter[s][t][d]
                    pos = np.searchsorted(ids, sub[0][sel])
                    src_local[sel] = (rows_per + D * H1
                                      + (d * S + s) * H2 + pos)
            dst_local = sub[1] - p * rows_per
            edge_out[t, dc, 0, :E_p] = src_local
            edge_out[t, dc, 1, :E_p] = dst_local
            edge_out[t, dc, 1, E_p:] = rows_per  # pads: dropped by the sum
            w_out[t, dc, :E_p] = sub_w

    return HierHaloPartition(edge_out, w_out, send_intra, send_inter,
                             S, D, rows_per, H1, H2, num_nodes,
                             inter_rows, inter_rows_flat, intra_rows)


def _all_gather(x, group, size):
    """(size * rows, F): every process's ``x`` stacked in group-rank order."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _AllGather(torch.autograd.Function):
    """`_all_gather`, differentiable: its transpose sends each process its
    chunk of the cotangent (one ``all_to_all``) and sums the chunks in
    group-rank order, so every part sums in one fixed order."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _all_gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        recv = _Exchange.apply(g.contiguous(), ctx.group)
        return recv.view(ctx.size, -1, *g.shape[1:]).sum(0), None, None


def _grid_arrays(base, grid):
    """This part's (send_intra (D*H1,), send_inter (S*H2,)) as int64."""
    s, d = grid.s, grid.d
    return (base.send_intra[s, d].reshape(-1).astype(np.int64),
            base.send_inter[s, d].reshape(-1).astype(np.int64))


def make_hier_halo_spmm(part: HierHaloPartition, groups=None):
    """The two-level tier: ``spmm(x_blk) -> (rows_per, F)`` for this
    process's part, ``x_blk`` its own (rows_per, F) block.

    ``groups`` is this process's `HierGrid` (None: `hier_world` over the
    default group, which creates the groups). The intra exchange over dp,
    the inter exchange over slice, the ``all_gather`` over dp of the
    inter rows, then the segment sum of the weighted ``[own | intra |
    inter]`` rows into the owned rows, in float32 (the weights are), as
    in the JAX tier. Differentiable through autograd.
    """
    grid = hier_world(part.num_slices, part.dp_per_slice, groups)
    rows_per, S, D = part.rows_per, part.num_slices, part.dp_per_slice
    s, d = grid.s, grid.d
    arrays = (part.edge_index[s, d, 0].astype(np.int64),
              part.edge_index[s, d, 1].astype(np.int64),
              part.edge_weight[s, d]) + _grid_arrays(part, grid)
    placed = {}

    def spmm(x_blk):
        if x_blk.dim() != 2 or x_blk.shape[0] != rows_per:
            raise ValueError(f"x_blk must be this part's ({rows_per}, F) "
                             f"block, got {tuple(x_blk.shape)}")
        dev = x_blk.device
        if dev not in placed:
            placed[dev] = tuple(torch.from_numpy(a).to(dev) for a in arrays)
        src, dst, w, send1, send2 = placed[dev]
        # an axis of one process runs no collective: its chunk is its own
        recv1, recv2 = x_blk[send1], x_blk[send2]
        if D > 1:
            recv1 = _Exchange.apply(recv1, grid.dp)
        if S > 1:
            recv2 = _Exchange.apply(recv2, grid.slice)
        if D > 1:  # the inter table, [d_owner, s, pos]
            recv2 = _AllGather.apply(recv2, grid.dp, D)
        table = torch.cat([x_blk, recv1, recv2])
        return segment_sum(table[src] * w[:, None], dst, rows_per)

    return spmm


def traffic_report(part: HierHaloPartition, feat_dim, dtype=torch.bfloat16):
    """Boundary traffic of one layer, in bytes.

    ``dcn_bytes`` is what crosses between slices under this scheme (each
    row once per consumer slice), ``dcn_bytes_flat`` what a flat
    ``all_to_all`` over all S*D parts would send there (every consumer
    part's copy), ``ici_bytes`` the traffic within slices: the intra halo
    rows plus the redistribute ``all_gather`` ((D-1) copies of the inter
    rows). ``dtype`` is a torch or numpy dtype.
    """
    itemsize = (torch.empty((), dtype=dtype).element_size()
                if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    b = int(itemsize) * int(feat_dim)
    D = part.dp_per_slice
    dcn = part.inter_rows * b
    dcn_flat = part.inter_rows_flat * b
    ici = part.intra_rows * b + (D - 1) * part.inter_rows * b
    return {"dcn_bytes": dcn, "dcn_bytes_flat": dcn_flat,
            "dcn_dedup_factor": (part.inter_rows_flat
                                 / max(1, part.inter_rows)),
            "ici_bytes": ici}
