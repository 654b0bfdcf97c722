"""The wave-3 models: SGFormer, GNN-LF/HF, HiD-Net, CAGCN, HPN, ieHGCN,
RoheHAN, MERIT, GRADE and TADW (counterparts of
`gammagl_tpu/models/wave3_models.py`; reference: gammagl/models/
{sgformer,gnnlfhf,hid_net,cagcn,hpn,iehgcn,rohehan,merit,grade,tadw}.py).

All are COO, as in the JAX package: they take no plan and run no kernel.
`tadw` keeps JAX's host numpy draws and runs its iterations in torch on
the device it is given.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.conv.hetero_conv import _fan_in
from gammagl_tpu_torch.layers.conv.hetero_wave2 import (HidConv, HPNConv,
                                                        RoheHANConv,
                                                        ieHGCNConv)
from gammagl_tpu_torch.layers.conv.simple_convs import _gcn_weights
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.models.simple_models import _Dense
from gammagl_tpu_torch.models.ssl import GraceModel, _GCNEncoder
from gammagl_tpu_torch.ops.spmm import spmm
from gammagl_tpu_torch.utils.device import resolve_device

__all__ = ["SGFormerModel", "GNNLFHFModel", "HiDNetModel", "CAGCNModel",
           "HPNModel", "ieHGCNModel", "RoheHANModel", "MERITModel",
           "GRADEModel", "tadw"]


def _unit_rows(t):
    """t over (its L2 norm + 1e-12) on the last axis."""
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)


class SGFormerModel(nn.Module):
    """SGFormer (Wu et al. 2023): one linear global attention layer
    (l2-normalised q and k, the sums taken in the associative order, N
    added to the denominator, v as the self term), a COO GCN branch of
    ``gcn_layers`` layers, the two mixed by ``graph_weight``, ReLU, then
    the head. flax names: ``Dense_0`` (h), ``Dense_1`` to ``Dense_3``
    (q, k, v, bias-free), ``GCNConv_{i}``, ``Dense_4`` (the head).
    Dropout (between the GCN layers) acts in training mode and draws from
    ``generator``."""

    def __init__(self, hidden_dim=64, num_class=7, num_heads=1, gcn_layers=2,
                 graph_weight=0.8, drop_rate=0.5, in_channels=None):
        super().__init__()
        H, D = num_heads, hidden_dim
        self.num_heads, self.hidden_dim = H, D
        self.graph_weight, self.drop_rate = graph_weight, drop_rate
        self.lin = lecun_dense(in_channels, D)
        self.q = lecun_dense(D, H * D, bias=False)
        self.k = lecun_dense(D, H * D, bias=False)
        self.v = lecun_dense(D, H * D, bias=False)
        self.convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else D, D)
            for i in range(gcn_layers))
        self.head = lecun_dense(D, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.lin, "Dense_1": self.q, "Dense_2": self.k,
                "Dense_3": self.v, "Dense_4": self.head}
        tree.update({f"GCNConv_{i}": c for i, c in enumerate(self.convs)})
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                generator=None):
        H, D = self.num_heads, self.hidden_dim
        rate = self.drop_rate if self.training else 0.0
        h = lecun_apply(self.lin, x)
        q = _unit_rows(lecun_apply(self.q, h).reshape(-1, H, D))
        k = _unit_rows(lecun_apply(self.k, h).reshape(-1, H, D))
        v = lecun_apply(self.v, h).reshape(-1, H, D)
        kv = torch.einsum("nhd,nhe->hde", k, v)
        num = torch.einsum("nhd,hde->nhe", q, kv)
        den = torch.einsum("nhd,hd->nh", q, k.sum(0))[..., None] + x.shape[0]
        attn_out = ((num + v) / den).mean(1)
        g = x
        for conv in self.convs[:-1]:
            g = dropout(F.relu(conv(g, edge_index, edge_weight, num_nodes)),
                        rate, generator)
        g = self.convs[-1](g, edge_index, edge_weight, num_nodes)
        out = self.graph_weight * g + (1 - self.graph_weight) * attn_out
        return lecun_apply(self.head, F.relu(out))


class GNNLFHFModel(nn.Module):
    """GNN-LF/HF (Zhu et al. 2021): an MLP to ``num_class`` (``Dense_0``,
    ``Dense_1``, dropout around the first), then ``K`` closed-form
    propagation steps on the GCN-normalised COO `spmm`: the low-pass
    ``variant='lf'`` (2 products a step) or the high-pass ``'hf'`` (1)."""

    def __init__(self, hidden_dim=64, num_class=7, variant="lf", alpha=0.1,
                 mu=0.1, beta=0.5, K=10, drop_rate=0.5, in_channels=None):
        super().__init__()
        if variant not in ("lf", "hf"):
            raise ValueError(f"invalid variant {variant!r}")
        self.variant, self.alpha, self.mu, self.beta = variant, alpha, mu, beta
        self.K, self.drop_rate = K, drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.lin1 = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                generator=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        rate = self.drop_rate if self.training else 0.0
        h = dropout(x, rate, generator)
        h = dropout(F.relu(lecun_apply(self.lin0, h)), rate, generator)
        h = lecun_apply(self.lin1, h)
        w = _gcn_weights(edge_index, num_nodes, edge_weight, h.dtype)

        def prop(z):
            return spmm(edge_index, w, z, num_nodes=num_nodes)

        h0, a = h, self.alpha
        for _ in range(self.K):
            if self.variant == "lf":
                ah = prop(h)
                h = ((1 - a) * ((1 - self.mu) * ah + self.mu * prop(ah))
                     + a * h0)
            else:
                ah = prop(h)
                h = (1 - a) * (ah + self.beta * (h - ah)) + a * h0
        return h


class CAGCNModel(nn.Module):
    """CAGCN's calibration: two COO GCNConvs (``GCNConv_0`` to
    ``hidden_dim``, ReLU, ``GCNConv_1`` to 1) give each node a temperature
    softplus(t) + 1e-3 that divides the given logits."""

    def __init__(self, num_class, hidden_dim=16, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.conv0 = GCNConv(in_channels, hidden_dim)
        self.conv1 = GCNConv(hidden_dim, 1)

    def flax_tree(self):
        return {"GCNConv_0": self.conv0, "GCNConv_1": self.conv1}

    def forward(self, logits, edge_index, num_nodes=None):
        t = F.relu(self.conv0(logits, edge_index, num_nodes=num_nodes))
        t = self.conv1(t, edge_index, num_nodes=num_nodes)
        return logits / (F.softplus(t) + 1e-3)


class HiDNetModel(nn.Module):
    """HiD-Net (Li et al. 2023): dropout, a ReLU map to ``hidden_dim``
    (``Dense_0``), dropout, a map to ``num_class`` (``Dense_1``, giving
    the origin), then ``num_layers`` `HidConv` diffusion steps. Dropout
    is active in training mode only and draws from ``generator``."""

    def __init__(self, hidden_dim=64, num_class=7, num_layers=10, alpha=0.1,
                 beta=0.9, gamma=0.3, drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.lin1 = lecun_dense(hidden_dim, num_class)
        self.convs = nn.ModuleList(HidConv(alpha=alpha, beta=beta,
                                           gamma=gamma)
                                   for _ in range(num_layers))

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                generator=None):
        rate = self.drop_rate if self.training else 0.0
        h = dropout(x, rate, generator)
        h = dropout(F.relu(lecun_apply(self.lin0, h)), rate, generator)
        h = origin = lecun_apply(self.lin1, h)
        for conv in self.convs:
            h = conv(h, origin, edge_index, edge_weight, num_nodes)
        return h


class HPNModel(nn.Module):
    """`HPNConv` (``HPNConv_0``: ``hidden_channels``, ``iter_K`` APPNP
    steps at ``alpha``), then a map of the target type to ``num_class``
    (``Dense_0``). ``in_channels``: an int, a dict by node type, or None
    (lazy)."""

    def __init__(self, metadata, hidden_channels, num_class, target_ntype,
                 iter_K=3, alpha=0.1, in_channels=None):
        super().__init__()
        self.target_ntype = target_ntype
        self.conv = HPNConv(in_channels, hidden_channels, metadata,
                            iter_K=iter_K, alpha=alpha)
        self.lin = lecun_dense(hidden_channels, num_class)

    def flax_tree(self):
        return {"HPNConv_0": self.conv, "Dense_0": self.lin}

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None):
        out = self.conv(x_dict, edge_index_dict, num_nodes_dict)
        return lecun_apply(self.lin, out[self.target_ntype])


class RoheHANModel(nn.Module):
    """`RoheHANConv` (``RoheHANConv_0``: ``heads`` heads of
    ``hidden_channels``; ``trust_dict`` purifies its attention), then a
    map of the target type to ``num_class`` (``Dense_0``)."""

    def __init__(self, metadata, hidden_channels, num_class, target_ntype,
                 heads=8, in_channels=None):
        super().__init__()
        self.target_ntype = target_ntype
        self.conv = RoheHANConv(in_channels, hidden_channels, metadata,
                                heads=heads)
        self.lin = lecun_dense(heads * hidden_channels, num_class)

    def flax_tree(self):
        return {"RoheHANConv_0": self.conv, "Dense_0": self.lin}

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None,
                trust_dict=None):
        out = self.conv(x_dict, edge_index_dict, num_nodes_dict, trust_dict)
        return lecun_apply(self.lin, out[self.target_ntype])


class ieHGCNModel(nn.Module):
    """Every node type mapped to ``hidden_channels`` (``proj__{type}``,
    ReLU), ``num_layers`` `ieHGCNConv`s (``conv_{i}``), then a map of the
    target type to ``num_class`` (``Dense_0``)."""

    def __init__(self, metadata, hidden_channels, num_class, target_ntype,
                 num_layers=2, in_channels=None):
        super().__init__()
        self.target_ntype = target_ntype
        self.proj = nn.ModuleDict({
            nt: lecun_dense(_fan_in(in_channels, nt), hidden_channels)
            for nt in metadata[0]})
        self.convs = nn.ModuleList(
            ieHGCNConv(hidden_channels, hidden_channels, metadata)
            for _ in range(num_layers))
        self.lin = lecun_dense(hidden_channels, num_class)

    def flax_tree(self):
        tree = {f"proj__{nt}": lin for nt, lin in self.proj.items()}
        tree.update({f"conv_{i}": c for i, c in enumerate(self.convs)})
        tree["Dense_0"] = self.lin
        return tree

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None):
        h = {nt: F.relu(lecun_apply(self.proj[nt], x))
             for nt, x in x_dict.items()}
        for conv in self.convs:
            h = conv(h, edge_index_dict, num_nodes_dict)
        return lecun_apply(self.lin, h[self.target_ntype])


class MERITModel(nn.Module):
    """MERIT (Jin et al. 2021): a siamese ReLU GCN encoder
    (``_GCNEncoder_0``), a projector (``Dense_0``, ReLU, ``Dense_1``) and a
    predictor (``Dense_2``, ReLU, ``Dense_3``); the forward gives both
    views' predictions, `byol_loss` the BYOL-style loss."""

    def __init__(self, hidden_dim=128, num_layers=2, in_channels=None):
        super().__init__()
        self.enc = _GCNEncoder(hidden_dim, num_layers, act="relu",
                               in_channels=in_channels)
        self.proj = nn.Sequential(_Dense(hidden_dim, hidden_dim), nn.ReLU(),
                                  _Dense(hidden_dim, hidden_dim))
        self.pred = nn.Sequential(_Dense(hidden_dim, hidden_dim), nn.ReLU(),
                                  _Dense(hidden_dim, hidden_dim))

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc, "Dense_0": self.proj[0].lin,
                "Dense_1": self.proj[2].lin, "Dense_2": self.pred[0].lin,
                "Dense_3": self.pred[2].lin}

    def forward(self, x1, ei1, w1, x2, ei2, w2, num_nodes=None):
        z1 = self.pred(self.proj(self.enc(x1, ei1, w1, num_nodes)))
        z2 = self.pred(self.proj(self.enc(x2, ei2, w2, num_nodes)))
        return z1, z2

    @staticmethod
    def byol_loss(p, z_target):
        """mean(2 - 2 cos(p, z_target)), each row normalised by its norm
        + 1e-12. The target is not detached, as in JAX."""
        return (2 - 2 * (_unit_rows(p) * _unit_rows(z_target)).sum(-1)
                ).mean()


class GRADEModel(GraceModel):
    """GRADE (Wang et al. 2022): GRACE's two views, ReLU GCN encoder
    (``_GCNEncoder_0``) and NT-Xent (`grace_loss`, tau ``tau``), its
    projection head ``hidden_dim`` wide (``Dense_0``, ELU, ``Dense_1``).
    Without the second view the forward returns the first view's
    embeddings."""

    def __init__(self, hidden_dim=128, num_layers=2, tau=0.5,
                 in_channels=None):
        super().__init__(hidden_dim, hidden_dim, num_layers, tau,
                         in_channels)


def tadw(adj, text_features, dim=80, lam=0.2, iters=20, lr=0.01, seed=0,
         device=None):
    """Text-Associated DeepWalk (Yang et al. 2015): factorise
    M = (A_rw + A_rw^2) / 2 ~= W^T H T by gradient steps, T the text
    matrix. W and H are drawn as in JAX (``np.random.default_rng(seed)``,
    normal times 0.1, float32); the ``iters`` steps run in torch on
    ``device`` (None: the card). Returns the (N, 2 dim) float32 numpy embeddings
    [W^T || (H T)^T]."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = np.asarray(adj, np.float32)
    deg = a.sum(1, keepdims=True)
    m = a / np.maximum(deg, 1)
    m = (m + m @ m) / 2
    t = np.asarray(text_features, np.float32).T  # (ft, N)
    ft, n = t.shape
    w = rng.normal(size=(dim, n)).astype(np.float32) * 0.1
    h = rng.normal(size=(dim, ft)).astype(np.float32) * 0.1
    m, t, w, h = (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for v in (m, t, w, h))
    for _ in range(iters):
        ht = h @ t
        err = w.T @ ht - m
        w = w - lr * (ht @ err.T + lam * w)
        h = h - lr * ((w @ err) @ t.T + lam * h)
    return torch.cat([w.T, (h @ t).T], 1).cpu().numpy()
