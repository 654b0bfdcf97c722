"""HiD-Net, HPN, ieHGCN and RoheHAN models (counterparts of four of the
models of `gammagl_tpu/models/wave3_models.py`; its SGFormer, GNN-LF/HF,
CAGCN, MERIT, GRADE and TADW are not ported yet). All four are COO, as in
the JAX package: they take no plan and run no kernel.
"""

import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv.hetero_conv import _fan_in
from gammagl_tpu_torch.layers.conv.hetero_wave2 import (HidConv, HPNConv,
                                                        RoheHANConv,
                                                        ieHGCNConv)
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense

__all__ = ["HiDNetModel", "HPNModel", "ieHGCNModel", "RoheHANModel"]


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
