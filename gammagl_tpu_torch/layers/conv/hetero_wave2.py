"""HPN, ieHGCN, HiD-Net and RoheHAN convolutions (counterparts of
`gammagl_tpu/layers/conv/hetero_wave2.py`).

All four are COO, as in the JAX package: segment sums, counts and
softmaxes, gathers and the COO `spmm` / `bspmm`, with no plan and no
kernel. `HPNConv` propagates each metapath relation with `APPNPConv` and
blends the relations that land on a type with one shared `SemAttAggr`.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv.gat_conv import truncated_normal_
from gammagl_tpu_torch.layers.conv.hetero_conv import (SemAttAggr, _fan_in,
                                                       _name)
from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.conv.simple_convs import APPNPConv, _dis
from gammagl_tpu_torch.layers.dense import (dense, glorot_dense,
                                            glorot_uniform_, lecun_dense,
                                            lecun_normal_)
from gammagl_tpu_torch.ops import bspmm, segment_mean, segment_softmax

__all__ = ["HPNConv", "ieHGCNConv", "HidConv", "RoheHANConv"]


def _n_dst(x_dict, num_nodes_dict, dst_t):
    return (num_nodes_dict[dst_t] if num_nodes_dict
            else x_dict[dst_t].shape[0])


def _mean_from_src(h, edge_index, n_dst):
    """Mean of the source rows over each destination's edges (0 where it
    has none), the sources gathered clamped."""
    msg = h[edge_index[0].long().clamp(0, h.shape[0] - 1)]
    return segment_mean(msg, edge_index[1], n_dst)


class HPNConv(nn.Module):
    """Heterogeneous graph propagation (Ji et al. 2021): each relation's
    source rows mapped to ``out_channels`` (flax ``proj__{src}__{rel}__
    {dst}``, lecun-normal with bias), then on a relation inside one type
    (a metapath) ``iter_K`` APPNP steps at ``alpha``, on a relation across
    types the mean over each destination's edges; a ReLU, and the
    relations that land on a type blended by one shared `SemAttAggr`
    (``SemAttAggr_0``). ``in_channels``: an int, a dict by node type, or
    None (lazy)."""

    def __init__(self, in_channels, out_channels, metadata, iter_K=3,
                 alpha=0.1):
        super().__init__()
        self.edge_types = [tuple(et) for et in metadata[1]]
        self.proj = nn.ModuleDict({
            _name(et): lecun_dense(_fan_in(in_channels, et[0]),
                                   out_channels)
            for et in self.edge_types})
        self.appnp = APPNPConv(itera_k=iter_K, alpha=alpha)
        self.sem = SemAttAggr(out_channels, out_channels)

    def flax_tree(self):
        tree = {f"proj__{k}": lin for k, lin in self.proj.items()}
        tree["SemAttAggr_0"] = self.sem
        return tree

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None):
        out_lists = {nt: [] for nt in x_dict}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = _n_dst(x_dict, num_nodes_dict, dst_t)
            ei = edge_index_dict[et]
            h = dense(self.proj[_name(et)], x_dict[src_t], None,
                      lecun_normal_)
            if src_t == dst_t:
                h = self.appnp(h, ei, num_nodes=n_dst)
            else:
                h = _mean_from_src(h, ei, n_dst)
            out_lists[dst_t].append(F.relu(h))
        return {nt: self.sem(torch.stack(v, 0))
                for nt, v in out_lists.items() if v}


class ieHGCNConv(nn.Module):
    """ieHGCN (Yang et al. 2021): each type's rows mapped to
    ``out_channels`` (``w_self__{type}``) and, for each relation into it,
    the mean of the mapped source rows (``w__{src}__{rel}__{dst}``; both
    glorot kernels, bias); then at each type a query of its own rows
    (``q__{type}``) and a key of each candidate (itself first, then its
    relations in ``metadata`` order: ``k__{type}__{i}``, ``attn_channels``
    wide, lecun-normal) give a softmax over the candidates that blends
    them. ``in_channels``: an int, a dict by node type, or None (lazy)."""

    def __init__(self, in_channels, out_channels, metadata,
                 attn_channels=32):
        super().__init__()
        node_types = list(metadata[0])
        self.edge_types = [tuple(et) for et in metadata[1]]
        self.w_self = nn.ModuleDict({
            nt: glorot_dense(_fan_in(in_channels, nt), out_channels)
            for nt in node_types})
        self.w = nn.ModuleDict({
            _name(et): glorot_dense(_fan_in(in_channels, et[0]),
                                    out_channels)
            for et in self.edge_types})
        self.q = nn.ModuleDict({nt: lecun_dense(out_channels, attn_channels)
                                for nt in node_types})
        self.k = nn.ModuleDict({
            nt: nn.ModuleList(
                lecun_dense(out_channels, attn_channels) for _ in range(
                    1 + sum(et[2] == nt for et in self.edge_types)))
            for nt in node_types})

    def flax_tree(self):
        tree = {f"w_self__{nt}": lin for nt, lin in self.w_self.items()}
        tree.update({f"w__{k}": lin for k, lin in self.w.items()})
        tree.update({f"q__{nt}": lin for nt, lin in self.q.items()})
        for nt, keys in self.k.items():
            tree.update({f"k__{nt}__{i}": lin for i, lin in enumerate(keys)})
        return tree

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None):
        self_h = {nt: dense(self.w_self[nt], x, None, glorot_uniform_)
                  for nt, x in x_dict.items()}
        agg = {nt: [] for nt in x_dict}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            h = dense(self.w[_name(et)], x_dict[src_t], None,
                      glorot_uniform_)
            agg[dst_t].append(_mean_from_src(
                h, edge_index_dict[et],
                _n_dst(x_dict, num_nodes_dict, dst_t)))
        out = {}
        for nt, parts in agg.items():
            cands = [self_h[nt]] + parts
            q = dense(self.q[nt], self_h[nt], None, lecun_normal_)
            scores = torch.stack([
                (q * dense(k, c, None, lecun_normal_)).sum(-1)
                for k, c in zip(self.k[nt], cands)], 0)
            att = torch.softmax(scores, 0)
            out[nt] = (att[..., None] * torch.stack(cands, 0)).sum(0)
        return out


class HidConv(MessagePassing):
    """HiD-Net's diffusion step (Li et al. 2023): with A_hat the symmetric
    degree-normalised adjacency, ax = A_hat x and a2x = A_hat ax (COO),
    out = alpha origin + beta ax + gamma sigmoid(sigma (ax - a2x)) (ax -
    a2x). No parameters."""

    def __init__(self, alpha=0.1, beta=0.9, gamma=0.3, sigma=0.5):
        super().__init__()
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.sigma = sigma

    def flax_tree(self):
        return {}

    def forward(self, x, origin, edge_index, edge_weight=None,
                num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        d_src, d_dst = _dis(edge_index[1].long(), num_nodes, edge_index)
        w = d_src * d_dst
        if edge_weight is not None:
            w = w * edge_weight.float()
        w = w.to(x.dtype)
        ax = self.propagate(x, edge_index, edge_weight=w,
                            num_nodes=num_nodes)
        a2x = self.propagate(ax, edge_index, edge_weight=w,
                             num_nodes=num_nodes)
        g = torch.sigmoid(self.sigma * (ax - a2x))
        return (self.alpha * origin + self.beta * ax
                + self.gamma * g * (ax - a2x))


class RoheHANConv(nn.Module):
    """Robust HAN (Zhang et al. 2022): per relation a bias-free map to
    ``heads`` x ``out_channels`` (``w__{src}__{rel}__{dst}``) and GAT
    scores leaky_relu(att . [h_s || h_d]) (``att__{...}``, (1, H, 2F),
    truncated_normal(0.02)); where ``trust_dict`` holds the relation,
    edges of trust <= 0 score -1e9 before the softmax (attention
    purification); the softmax-weighted sum (`bspmm`), a ReLU, and the
    relations that land on a type blended by one shared `SemAttAggr`
    (``SemAttAggr_0``, hidden size ``out_channels``).

    The score's two halves are taken once a node (H scores each), not on
    an (E, H, 2F) concatenation: the same sum, without the per-edge
    tensor. ``in_channels``: an int, a dict by node type, or None.
    """

    def __init__(self, in_channels, out_channels, metadata, heads=1,
                 negative_slope=0.2):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.negative_slope = negative_slope
        self.edge_types = [tuple(et) for et in metadata[1]]
        self.w = nn.ModuleDict({
            _name(et): lecun_dense(_fan_in(in_channels, et[0]),
                               heads * out_channels, bias=False)
            for et in self.edge_types})
        self.att = nn.ParameterDict({
            _name(et): nn.Parameter(truncated_normal_(
                torch.empty(1, heads, 2 * out_channels)))
            for et in self.edge_types})
        self.sem = SemAttAggr(heads * out_channels, out_channels)

    def flax_tree(self):
        tree = {f"w__{k}": lin for k, lin in self.w.items()}
        tree.update({f"att__{k}": p for k, p in self.att.items()})
        tree["SemAttAggr_0"] = self.sem
        return tree

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None,
                trust_dict=None):
        H, Fo = self.heads, self.out_channels
        out_lists = {nt: [] for nt in x_dict}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            name = _name(et)
            ei = edge_index_dict[et]
            n_dst = _n_dst(x_dict, num_nodes_dict, dst_t)
            h = dense(self.w[name], x_dict[src_t], None,
                      lecun_normal_).reshape(-1, H, Fo)
            att = self.att[name].to(h.dtype)
            last = h.shape[0] - 1
            src = ei[0].long().clamp(0, last)
            dst = ei[1].long().clamp(0, last)
            e = ((h * att[..., :Fo]).sum(-1)[src]
                 + (h * att[..., Fo:]).sum(-1)[dst])
            e = F.leaky_relu(e, self.negative_slope)
            if trust_dict is not None and et in trust_dict:
                e = torch.where(trust_dict[et][:, None] > 0, e, -1e9)
            alpha = segment_softmax(e, ei[1], n_dst)
            out = bspmm(ei, alpha, h, num_nodes=n_dst).reshape(-1, H * Fo)
            out_lists[dst_t].append(F.relu(out))
        return {nt: self.sem(torch.stack(v, 0))
                for nt, v in out_lists.items() if v}
