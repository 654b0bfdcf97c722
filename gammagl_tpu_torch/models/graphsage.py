"""GraphSAGE models, counterparts of `gammagl_tpu/models/graphsage.py`.

The full-graph model takes the whole edge set (and a `CSRPlan` for the
kernels); the sampled model takes per-layer bipartite blocks, outermost
hop first, given by the caller (the port has no neighbour sampler yet).
"""

import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import SAGEConv
from gammagl_tpu_torch.models.gat import dropout

__all__ = ["GraphSAGEModel", "GraphSAGESampleModel"]


class GraphSAGEModel(nn.Module):
    """``num_layers`` SAGEConvs with ReLU and dropout between them; flax
    names ``SAGEConv_0`` ... ``SAGEConv_{num_layers-1}``. ``dtype`` is the
    compute dtype (parameters stay float32); the first layer's in-features
    come from ``in_channels``, the first input or `load_jax_params`.
    Dropout is active in training mode only, drawn from ``generator``
    (None: the default one), so the plan and COO paths can share masks."""

    def __init__(self, hidden_dim=64, num_class=7, num_layers=2, aggr="mean",
                 drop_rate=0.5, dtype=None, in_channels=None):
        super().__init__()
        dims = [in_channels] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], aggr=aggr, dtype=dtype)
            for i in range(num_layers))
        self.drop_rate = drop_rate

    def flax_tree(self):
        return {f"SAGEConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, num_nodes=None, plan=None,
                generator=None):
        rate = self.drop_rate if self.training else 0.0
        for conv in self.convs[:-1]:
            x = F.relu(conv(x, edge_index, num_nodes, plan=plan))
            x = dropout(x, rate, generator)
        return self.convs[-1](x, edge_index, num_nodes, plan=plan)


class GraphSAGESampleModel(nn.Module):
    """Minibatch GraphSAGE over sampled bipartite blocks: ``adjs`` is a
    sequence of (edge_index, size_dst) pairs, outermost hop first, and the
    first ``size_dst`` rows of each layer's input are its destination
    nodes. The plain path runs (no plan per block)."""

    def __init__(self, hidden_dim=64, num_class=41, num_layers=2,
                 aggr="mean", drop_rate=0.5, dtype=None, in_channels=None):
        super().__init__()
        dims = [in_channels] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], aggr=aggr, dtype=dtype)
            for i in range(num_layers))
        self.drop_rate = drop_rate

    flax_tree = GraphSAGEModel.flax_tree

    def forward(self, x, adjs, generator=None):
        rate = self.drop_rate if self.training else 0.0
        last = len(self.convs) - 1
        for i, (edge_index, size_dst) in enumerate(adjs):
            x = self.convs[i]((x, x[:size_dst]), edge_index,
                              num_nodes=size_dst)
            if i < last:
                x = dropout(F.relu(x), rate, generator)
        return x
