"""Heterogeneous models, counterparts of `gammagl_tpu/models/hetero.py`:
`HGTModel`."""

import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv import HGTConv
from gammagl_tpu_torch.layers.dense import dense, fan_in_normal_

__all__ = ["HGTModel"]


def lecun_normal_(weight):
    """flax's default ``Dense`` kernel init."""
    return fan_in_normal_(weight, 1.0)


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
            self._init(lin)

    @staticmethod
    def _init(lin):
        if not isinstance(lin.weight, UninitializedParameter):
            lecun_normal_(lin.weight)
            nn.init.zeros_(lin.bias)

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
