"""Heterogeneous models, counterparts of `gammagl_tpu/models/hetero.py`:
`RGCNModel`, `HANModel`, `HGTModel` and `SimpleHGNModel`."""

import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import (HANConv, HGTConv, RGCNConv,
                                           SimpleHGNConv)
from gammagl_tpu_torch.layers.dense import (dense, lecun_linear_,
                                            lecun_normal_)

__all__ = ["RGCNModel", "HANModel", "HGTModel", "SimpleHGNModel"]


class RGCNModel(nn.Module):
    """Two RGCNConvs, in -> ``hidden_channels`` -> ``num_class`` with a
    ReLU between (flax names ``RGCNConv_0``, ``RGCNConv_1``), each with
    ``num_bases`` bases or, when None, a full map a relation. The JAX model
    takes ``num_layers`` and builds two layers whatever it says; so does
    this one. ``plan``, a `CSRPlan` of the edges, sends both sums to the
    kernel."""

    def __init__(self, in_channels, hidden_channels, num_class,
                 num_relations, num_bases=None, num_layers=2):
        super().__init__()
        self.convs = nn.ModuleList([
            RGCNConv(in_channels, hidden_channels, num_relations,
                     num_bases=num_bases),
            RGCNConv(hidden_channels, num_class, num_relations,
                     num_bases=num_bases)])

    def flax_tree(self):
        return {f"RGCNConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, edge_type, num_nodes=None, plan=None):
        x = F.relu(self.convs[0](x, edge_index, edge_type, num_nodes,
                                 plan=plan))
        return self.convs[1](x, edge_index, edge_type, num_nodes, plan=plan)


class HANModel(nn.Module):
    """`HANConv` (``HANConv_0``: ``heads`` heads of ``hidden_channels``,
    attention dropout ``drop_rate`` in training mode), then a linear map
    of the target type to ``num_class`` (``Dense_0``). ``in_channels``: an
    int, a dict by node type, or None for lazy maps. ``plan_dict``
    (`HeteroGraph.csr_plans()`) sends each relation's GAT to the flash
    kernels; ``generator`` draws the attention masks."""

    def __init__(self, metadata, hidden_channels, num_class, target_ntype,
                 heads=8, drop_rate=0.6, in_channels=None):
        super().__init__()
        self.target_ntype = target_ntype
        self.conv = HANConv(in_channels, hidden_channels, metadata,
                            heads=heads, dropout_rate=drop_rate)
        self.lin = lecun_linear_(nn.Linear(heads * hidden_channels,
                                             num_class))

    def flax_tree(self):
        return {"HANConv_0": self.conv, "Dense_0": self.lin}

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None,
                plan_dict=None, generator=None):
        out = self.conv(x_dict, edge_index_dict, num_nodes_dict,
                        plan_dict=plan_dict, generator=generator)
        return dense(self.lin, out[self.target_ntype], None, lecun_normal_)


class HGTModel(nn.Module):
    """Every node type projected to ``hidden_channels`` (``proj__{nt}``,
    ReLU), ``num_layers`` HGTConvs (``hgt_{i}``, ``heads`` heads, attention
    dropout 0.2 in training mode, as the JAX model leaves it), then a
    linear map of the target type to ``num_class`` (``Dense_0``).
    ``dtype`` is the HGTConvs' compute dtype; the projections and the head
    compute in float32. ``in_channels``: an int, a dict by node type, or
    None for lazy projections.

    ``plan_dict`` (`HeteroGraph.csr_plans()`) sends each relation to the
    kernels (see `HGTConv` for the routes); ``generator`` draws the
    attention masks in training mode.
    """

    def __init__(self, metadata, hidden_channels, num_class, target_ntype,
                 heads=4, num_layers=2, dtype=None, in_channels=None):
        super().__init__()
        self.target_ntype = target_ntype
        node_types = list(metadata[0])

        def proj(nt):
            fan_in = (in_channels.get(nt) if isinstance(in_channels, dict)
                      else in_channels)
            return (nn.LazyLinear(hidden_channels) if fan_in is None
                    else nn.Linear(fan_in, hidden_channels))

        self.proj = nn.ModuleDict({nt: proj(nt) for nt in node_types})
        self.convs = nn.ModuleList(
            HGTConv(hidden_channels, hidden_channels, metadata, heads=heads,
                    dtype=dtype) for _ in range(num_layers))
        self.lin = nn.Linear(hidden_channels, num_class)
        for lin in list(self.proj.values()) + [self.lin]:
            lecun_linear_(lin)

    def flax_tree(self):
        tree = {f"proj__{nt}": lin for nt, lin in self.proj.items()}
        tree.update({f"hgt_{i}": conv for i, conv in enumerate(self.convs)})
        tree["Dense_0"] = self.lin
        return tree

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None,
                plan_dict=None, generator=None):
        h_dict = {nt: F.relu(dense(self.proj[nt], x, None, lecun_normal_))
                  for nt, x in x_dict.items()}
        for conv in self.convs:
            out = conv(h_dict, edge_index_dict, num_nodes_dict,
                       plan_dict=plan_dict, generator=generator)
            h_dict = {**h_dict, **out}
        return self.lin(h_dict[self.target_ntype])


class SimpleHGNModel(nn.Module):
    """``num_layers`` SimpleHGNConvs (``SimpleHGNConv_{i}``: ``heads``
    heads of ``hidden_channels``, edge-type embeddings of 32, attention
    dropout ``drop_rate`` in training mode, each layer's attention blended
    into the next's), an ELU after each, then a linear map to
    ``num_class`` (``Dense_0``). ``in_channels=None`` makes the first
    layer lazy. ``plan``, a `CSRPlan` of the edges, runs every layer on
    the kernels; ``generator`` draws the attention masks."""

    def __init__(self, num_etypes, hidden_channels, num_class, heads=8,
                 num_layers=2, drop_rate=0.5, in_channels=None):
        super().__init__()
        width = heads * hidden_channels
        self.convs = nn.ModuleList(
            SimpleHGNConv(in_channels if i == 0 else width, hidden_channels,
                          num_etypes, heads=heads, dropout_rate=drop_rate)
            for i in range(num_layers))
        self.lin = lecun_linear_(nn.Linear(width, num_class))

    def flax_tree(self):
        tree = {f"SimpleHGNConv_{i}": conv
                for i, conv in enumerate(self.convs)}
        tree["Dense_0"] = self.lin
        return tree

    def forward(self, x, edge_index, edge_type, num_nodes=None, plan=None,
                generator=None):
        alpha = None
        for conv in self.convs:
            x, alpha = conv(x, edge_index, edge_type, num_nodes,
                            alpha_prev=alpha, plan=plan, generator=generator)
            x = F.elu(x)
        return dense(self.lin, x, None, lecun_normal_)
