"""HeCo: co-contrastive learning on heterogeneous graphs (Wang et al.
2021), counterpart of `gammagl_tpu/models/heco.py`.

Two views of the target type's nodes: the network schema (attention over
each neighbour type's edges into the target, then over the types) and
the metapaths (a GCNConv on each metapath's graph, then semantic
attention), trained to agree by a cross-view contrastive loss whose
positives come from the metapaths. COO throughout, as in the JAX model:
the metapath GCNConvs take no plan.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.conv.gat_conv import truncated_normal_
from gammagl_tpu_torch.layers.conv.hetero_conv import (SemAttAggr, _fan_in,
                                                       _name)
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.ops import segment_softmax, spmm

__all__ = ["HeCoModel", "heco_contrast_loss"]


class _SchemaEncoder(nn.Module):
    """The network-schema view: for each relation into the target type, a
    softmax over each target node's edges of leaky_relu(att . [h_d ||
    h_s]) (``att__{src}__{rel}__{dst}``, (1, 2F), truncated_normal(0.02);
    each half scored once a node), the weighted sum of the source rows;
    then the relations blended by `SemAttAggr` (``SemAttAggr_0``)."""

    def __init__(self, hidden_dim, target, metadata):
        super().__init__()
        self.target = target
        self.edge_types = [tuple(et) for et in metadata[1]
                           if et[2] == target]
        self.att = nn.ParameterDict({
            _name(et): nn.Parameter(truncated_normal_(
                torch.empty(1, 2 * hidden_dim)))
            for et in self.edge_types})
        self.sem = SemAttAggr(hidden_dim, hidden_dim)

    def flax_tree(self):
        tree = {f"att__{k}": p for k, p in self.att.items()}
        tree["SemAttAggr_0"] = self.sem
        return tree

    def forward(self, h_dict, edge_index_dict, num_target):
        per_type = []
        h_dst = h_dict[self.target]
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            ei = edge_index_dict[et]
            h_src = h_dict[et[0]]
            att = self.att[_name(et)][0].to(h_dst.dtype).reshape(2, -1)
            src = ei[0].long().clamp(0, h_src.shape[0] - 1)
            dst = ei[1].long().clamp(0, h_dst.shape[0] - 1)
            e = F.leaky_relu((h_dst @ att[0])[dst] + (h_src @ att[1])[src],
                             0.2)
            alpha = segment_softmax(e, ei[1], num_target)
            per_type.append(spmm(ei, alpha, h_src, num_nodes=num_target))
        return self.sem(torch.stack(per_type, 0))


class _MetapathEncoder(nn.Module):
    """The metapath view: a ReLU `GCNConv` on each metapath's graph
    (``gcn_{i}``), blended by `SemAttAggr` (``SemAttAggr_0``)."""

    def __init__(self, hidden_dim, num_metapaths):
        super().__init__()
        self.gcns = nn.ModuleList(GCNConv(hidden_dim, hidden_dim)
                                  for _ in range(num_metapaths))
        self.sem = SemAttAggr(hidden_dim, hidden_dim)

    def flax_tree(self):
        tree = {f"gcn_{i}": gcn for i, gcn in enumerate(self.gcns)}
        tree["SemAttAggr_0"] = self.sem
        return tree

    def forward(self, h_target, metapath_edges, num_target):
        if len(metapath_edges) != len(self.gcns):
            raise ValueError(f"{len(metapath_edges)} metapath graphs for "
                             f"{len(self.gcns)} GCNConvs")
        outs = [F.relu(gcn(h_target, ei, num_nodes=num_target))
                for gcn, ei in zip(self.gcns, metapath_edges)]
        return self.sem(torch.stack(outs, 0))


def heco_contrast_loss(z_sc, z_mp, pos_mask, tau=0.8, lam=0.5):
    """Cross-view InfoNCE: with z normalised as z / (|z| + 1e-12) and
    sim = exp(z_sc z_mp^T / tau), each side's loss is -log(sum of sim
    over the row's positives (``pos_mask``, (N, N)) / (the row's sum +
    1e-12) + 1e-12); the mean of lam times the schema side plus 1 - lam
    times the metapath side."""
    def norm(z):
        return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True)
                    + 1e-12)

    sim12 = torch.exp(norm(z_sc) @ norm(z_mp).T / tau)
    pos = pos_mask.to(sim12.dtype)

    def side(sim, pos):
        return -torch.log((sim * pos).sum(1) / (sim.sum(1) + 1e-12) + 1e-12)

    return (lam * side(sim12, pos)
            + (1 - lam) * side(sim12.T, pos)).mean()


class HeCoModel(nn.Module):
    """HeCo: every node type mapped to ``hidden_dim`` (``proj__{type}``,
    dropout ``feat_drop`` in training mode from ``generator``, ELU); the
    schema view (``_SchemaEncoder_0``) and the metapath view
    (``_MetapathEncoder_0``, one GCNConv for each of ``num_metapaths``
    metapath graphs) of the target type. Without ``pos_mask`` it returns
    the metapath view's embeddings (for downstream evaluation); with it,
    `heco_contrast_loss` of both views through a shared projection
    (``Dense_0``, ELU, ``Dense_1``). ``in_channels``: an int, a dict by
    node type, or None (lazy)."""

    def __init__(self, metadata, target_ntype, hidden_dim=64, feat_drop=0.3,
                 tau=0.8, lam=0.5, num_metapaths=1, in_channels=None):
        super().__init__()
        self.target_ntype = target_ntype
        self.feat_drop, self.tau, self.lam = feat_drop, tau, lam
        self.proj = nn.ModuleDict({
            nt: lecun_dense(_fan_in(in_channels, nt), hidden_dim)
            for nt in metadata[0]})
        self.schema = _SchemaEncoder(hidden_dim, target_ntype, metadata)
        self.metapath = _MetapathEncoder(hidden_dim, num_metapaths)
        self.head = nn.ModuleList([lecun_dense(hidden_dim, hidden_dim),
                                   lecun_dense(hidden_dim, hidden_dim)])

    def flax_tree(self):
        tree = {f"proj__{nt}": lin for nt, lin in self.proj.items()}
        tree.update({"_SchemaEncoder_0": self.schema,
                     "_MetapathEncoder_0": self.metapath,
                     "Dense_0": self.head[0], "Dense_1": self.head[1]})
        return tree

    def forward(self, x_dict, edge_index_dict, metapath_edges,
                pos_mask=None, generator=None):
        rate = self.feat_drop if self.training else 0.0
        h = {nt: F.elu(dropout(lecun_apply(self.proj[nt], x), rate, generator))
             for nt, x in x_dict.items()}
        n_t = h[self.target_ntype].shape[0]
        z_mp = self.metapath(h[self.target_ntype], metapath_edges, n_t)
        if pos_mask is None:
            return z_mp
        z_sc = self.schema(h, edge_index_dict, n_t)

        def proj(z):
            return lecun_apply(self.head[1],
                               F.elu(lecun_apply(self.head[0], z)))

        return heco_contrast_loss(proj(z_sc), proj(z_mp), pos_mask,
                                  self.tau, self.lam)
