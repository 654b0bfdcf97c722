"""SIGN, the UniFews-pruned GCN, HardGAT, AdaGAD and Sp2GCL (counterparts
of `gammagl_tpu/models/wave5_models.py`; reference:
gammagl/models/{sign,gnn_unifews,hardgat,adagad,sp2gcl}.py).

They take no plan, as in the JAX package: their sums are the port's COO
ops on every device, so on the card they launch none of the hand-written
kernels. Each model names its flax counterpart's parameters in
``flax_tree`` (`utils.load_jax_params`); ``in_channels=None`` leaves the
first maps lazy, as flax infers them. Dropout is active in training mode
only and draws from a ``generator`` (None: the default generator of the
tensor's device).
"""

from math import inf

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.conv.gat_conv import truncated_normal_
from gammagl_tpu_torch.layers.conv.wave2_convs import _take
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.models.autoencoder import recon_loss
from gammagl_tpu_torch.models.ssl import grace_loss
from gammagl_tpu_torch.ops import bspmm, segment_max, segment_softmax
from gammagl_tpu_torch.utils.norm import calc_gcn_norm
from gammagl_tpu_torch.utils.pruning import _tree_map, prune_edges_by_weight

__all__ = ["SIGNModel", "GCNUniFews", "HardGATConv", "HardGATModel",
           "AdaGADModel", "Sp2GCLModel"]


class SIGNModel(nn.Module):
    """SIGN (Rossi 2020; reference sign.py): an MLP over the K + 1
    precomputed feature sets [x, x1..xK] (`transforms.SIGN`): each through
    dropout, its own map (``Dense_{k}``) and a ReLU, the results joined,
    dropout, and a map to the classes (``Dense_{K+1}``). Training reads no
    edges: its whole step is dense matrix products."""

    def __init__(self, num_class, hidden_dim=64, K=3, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lins = nn.ModuleList(lecun_dense(in_channels, hidden_dim)
                                  for _ in range(K + 1))
        self.out = lecun_dense((K + 1) * hidden_dim, num_class)

    def flax_tree(self):
        tree = {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}
        tree[f"Dense_{len(self.lins)}"] = self.out
        return tree

    def forward(self, xs, generator=None):
        rate = self.drop_rate if self.training else 0.0
        hs = [F.relu(lecun_apply(lin, dropout(x, rate, generator)))
              for lin, x in zip(self.lins, xs)]
        h = dropout(torch.cat(hs, dim=-1), rate, generator)
        return lecun_apply(self.out, h)


class GCNUniFews(nn.Module):
    """UniFews-pruned GCN (reference gcn_unifews.py:16-22): two GCNConvs
    (``GCNConv_0``, ReLU, ``GCNConv_1``) over edge weights whose magnitude
    is below ``edge_thr`` set to 0 (`prune_edges_by_weight`); without
    weights, the symmetric GCN norm (`calc_gcn_norm`) is the weight. Weight
    pruning is a step of the loop (`apply_weight_masks`)."""

    def __init__(self, num_class, hidden_dim=64, edge_thr=0.0,
                 weight_mask=None, in_channels=None):
        super().__init__()
        self.edge_thr = edge_thr
        self.weight_mask = weight_mask
        self.conv0 = GCNConv(in_channels, hidden_dim)
        self.conv1 = GCNConv(hidden_dim, num_class)

    def flax_tree(self):
        return {"GCNConv_0": self.conv0, "GCNConv_1": self.conv1}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if edge_weight is None:
            edge_weight = calc_gcn_norm(edge_index, num_nodes)
        if self.edge_thr > 0:
            edge_weight = prune_edges_by_weight(edge_weight, self.edge_thr)
        h = F.relu(self.conv0(x, edge_index, edge_weight, num_nodes))
        return self.conv1(h, edge_index, edge_weight, num_nodes)

    @staticmethod
    def apply_weight_masks(params, masks):
        """Each parameter times its mask (a tree of tensors, as
        `utils.pruning` takes)."""
        return _tree_map(lambda p, m: p * m, params, masks)


class HardGATConv(nn.Module):
    """Hard graph attention (Gao 2019; reference hardgat_conv.py): an edge
    takes part in its destination's softmax only when its source's scalar
    score (``Dense_0``, bias-free) is among the k largest of the
    destination's in-edges; the rest get a score of -1e9.

    The k-th score is found as in the JAX layer, by k rounds of peeling:
    each round takes the destination's largest remaining score (the COO
    `segment_max`) and removes every edge that ties it. A destination whose
    edges are all removed before round k sees a maximum of 0 (the segment
    max of only -inf, as in JAX), so its threshold ends at 0 and only its
    edges of score >= 0 are kept. Messages are ``Dense_1`` (bias-free, H
    heads of F) scored by ``att`` (1, H, 2F) on [h[src], h[dst]], leaky
    ReLU, and summed by `bspmm`. The selection carries no gradient.
    """

    def __init__(self, in_channels, out_channels, heads=1, k=8,
                 negative_slope=0.2):
        super().__init__()
        self.out_channels, self.heads, self.k = out_channels, heads, k
        self.negative_slope = negative_slope
        self.proj = lecun_dense(in_channels, 1, bias=False)
        self.lin = lecun_dense(in_channels, heads * out_channels, bias=False)
        self.att = nn.Parameter(truncated_normal_(
            torch.empty(1, heads, 2 * out_channels)))

    def flax_tree(self):
        return {"Dense_0": self.proj, "Dense_1": self.lin, "att": self.att}

    def keep_mask(self, x, edge_index, num_nodes=None):
        """(E,) booleans: the edges whose source score ranks in the top k
        of their destination (ties at the threshold all kept)."""
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        dst_c = dst.long().clamp(max=num_nodes - 1)
        with torch.no_grad():
            s_e = _take(lecun_apply(self.proj, x).reshape(-1), src)
            cur = s_e
            thr = torch.full((num_nodes,), inf, dtype=s_e.dtype,
                             device=s_e.device)
            for _ in range(self.k):
                m = segment_max(cur, dst, num_nodes)
                thr = torch.where(torch.isfinite(m), m, thr)
                cur = torch.where(cur >= m[dst_c], -inf, cur)
            return s_e >= thr[dst_c]

    def forward(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        H, Fo = self.heads, self.out_channels
        src, dst = edge_index[0], edge_index[1]
        keep = self.keep_mask(x, edge_index, num_nodes)
        h = lecun_apply(self.lin, x).reshape(-1, H, Fo)
        feat = torch.cat([_take(h, src), _take(h, dst)], dim=-1)
        e = F.leaky_relu((feat * self.att).sum(-1), self.negative_slope)
        e = torch.where(keep[:, None], e,
                        torch.full((), -1e9, dtype=e.dtype, device=e.device))
        alpha = segment_softmax(e, dst, num_nodes)
        return bspmm(edge_index, alpha, h,
                     num_nodes=num_nodes).reshape(-1, H * Fo)


class HardGATModel(nn.Module):
    """Two HardGATConvs (``HardGATConv_0``: ``heads`` heads of
    ``hidden_dim``, ELU; ``HardGATConv_1``: one head of ``num_class``)."""

    def __init__(self, hidden_dim=8, num_class=7, heads=8, k=8,
                 in_channels=None):
        super().__init__()
        self.conv0 = HardGATConv(in_channels, hidden_dim, heads=heads, k=k)
        self.conv1 = HardGATConv(hidden_dim * heads, num_class, heads=1,
                                 k=k)

    def flax_tree(self):
        return {"HardGATConv_0": self.conv0, "HardGATConv_1": self.conv1}

    def forward(self, x, edge_index, num_nodes=None):
        x = F.elu(self.conv0(x, edge_index, num_nodes))
        return self.conv1(x, edge_index, num_nodes)


class AdaGADModel(nn.Module):
    """AdaGAD anomaly detection (reference adagad.py PreModel): a GCN
    encoder (``GCNConv_0``, ReLU, ``GCNConv_1`` to ``latent_dim``), an
    attribute decoder (``Dense_1`` to ``hidden_dim``, ReLU, ``Dense_0``
    back to x's width) and a structure decoder (`recon_loss` of the latent
    rows). Without negative edges the forward gives each node's attribute
    error (its anomaly score), else the mean error plus the structure
    loss."""

    def __init__(self, hidden_dim=64, latent_dim=32, in_channels=None):
        super().__init__()
        self.conv0 = GCNConv(in_channels, hidden_dim)
        self.conv1 = GCNConv(hidden_dim, latent_dim)
        self.dec_hidden = lecun_dense(latent_dim, hidden_dim)
        # x's width is the output's: lazy (out-features set at first use)
        # when in_channels is not known
        self.dec_out = lecun_dense(None if in_channels is None else hidden_dim,
                                   in_channels or 0)

    def flax_tree(self):
        return {"GCNConv_0": self.conv0, "GCNConv_1": self.conv1,
                "Dense_0": self.dec_out, "Dense_1": self.dec_hidden}

    def forward(self, x, edge_index, neg_edge_index=None, num_nodes=None):
        h = F.relu(self.conv0(x, edge_index, num_nodes=num_nodes))
        z = self.conv1(h, edge_index, num_nodes=num_nodes)
        if isinstance(self.dec_out.weight, UninitializedParameter):
            self.dec_out.out_features = x.shape[-1]
        x_rec = lecun_apply(self.dec_out,
                            F.relu(lecun_apply(self.dec_hidden, z)))
        attr_err = ((x_rec - x) ** 2).sum(-1)
        if neg_edge_index is None:
            return attr_err
        return attr_err.mean() + recon_loss(z, edge_index, neg_edge_index)


class Sp2GCLModel(nn.Module):
    """Sp2GCL (Bo 2023; reference sp2gcl.py): a spatial view (two
    GCNConvs with a ReLU between) against a spectral view (``Dense_0``,
    ReLU, ``Dense_1`` on the Laplacian eigenvectors, computed on the host
    by `laplacian_eigh`), both through one projection head (``Dense_2``,
    ELU, ``Dense_3``); the forward is their `grace_loss`.
    ``spe_dim=None`` leaves the spectral map lazy."""

    def __init__(self, hidden_dim=64, tau=0.5, in_channels=None,
                 spe_dim=None):
        super().__init__()
        self.tau = tau
        self.conv0 = GCNConv(in_channels, hidden_dim)
        self.conv1 = GCNConv(hidden_dim, hidden_dim)
        self.spec0 = lecun_dense(spe_dim, hidden_dim)
        self.spec1 = lecun_dense(hidden_dim, hidden_dim)
        self.proj0 = lecun_dense(hidden_dim, hidden_dim)
        self.proj1 = lecun_dense(hidden_dim, hidden_dim)

    def flax_tree(self):
        return {"GCNConv_0": self.conv0, "GCNConv_1": self.conv1,
                "Dense_0": self.spec0, "Dense_1": self.spec1,
                "Dense_2": self.proj0, "Dense_3": self.proj1}

    def project(self, z):
        return lecun_apply(self.proj1, F.elu(lecun_apply(self.proj0, z)))

    def forward(self, x, edge_index, eigvecs, num_nodes=None):
        spatial = F.relu(self.conv0(x, edge_index, num_nodes=num_nodes))
        spatial = self.conv1(spatial, edge_index, num_nodes=num_nodes)
        spectral = lecun_apply(self.spec1,
                               F.relu(lecun_apply(self.spec0, eigvecs)))
        return grace_loss(self.project(spatial), self.project(spectral),
                          self.tau)
