"""PNA, CompGCN, DGCNN and GaAN models (counterparts of
`gammagl_tpu/models/wave2_models.py`).

They are built from the wave-2 convs (`layers/conv/wave2_convs.py`),
which take no plan, as in the JAX package: their sums are the port's
COO ops on every device. Each model names its flax counterpart's
parameters in ``flax_tree`` (`utils.load_jax_params`); ``in_channels=None``
leaves the first map lazy, as flax infers it.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.wave2_convs import (CompConv, EdgeConv,
                                                       GaANConv, PNAConv)
from gammagl_tpu_torch.layers.dense import (dropout, fan_in_normal_,
                                            glorot_uniform_, lecun_apply,
                                            lecun_dense)
from gammagl_tpu_torch.layers.pool import global_sort_pool

__all__ = ["PNAModel", "CompGCNModel", "DGCNNModel", "GaANModel"]


class PNAModel(nn.Module):
    """``num_layers`` PNAConvs (``PNAConv_{i}``), ReLU and dropout after
    each but the last, which maps to ``num_class``. Dropout is active in
    training mode only and draws from ``generator``."""

    def __init__(self, hidden_dim=64, num_class=7, num_layers=2,
                 drop_rate=0.3, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        dims = [in_channels] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.convs = nn.ModuleList(PNAConv(a, b)
                                   for a, b in zip(dims, dims[1:]))

    def flax_tree(self):
        return {f"PNAConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, num_nodes=None, generator=None):
        rate = self.drop_rate if self.training else 0.0
        for conv in self.convs[:-1]:
            x = dropout(F.relu(conv(x, edge_index, num_nodes)), rate,
                        generator)
        return self.convs[-1](x, edge_index, num_nodes)


class CompGCNModel(nn.Module):
    """Knowledge-graph encoder: relation embeddings ``rel_emb`` (R, F_in),
    glorot-uniform, threaded through ``num_layers`` CompConvs
    (``CompConv_{i}``), each of which maps both the nodes and the
    relations; ReLU between layers. ``in_channels=None`` leaves
    ``rel_emb`` (and the first conv) lazy: they take x's width at the
    first forward."""

    def __init__(self, num_relations, hidden_dim=64, num_class=4,
                 num_layers=2, op="sub", in_channels=None):
        super().__init__()
        self.num_relations = num_relations
        self.rel_emb = (UninitializedParameter() if in_channels is None
                        else nn.Parameter(glorot_uniform_(
                            torch.empty(num_relations, in_channels))))
        dims = [in_channels] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.convs = nn.ModuleList(CompConv(a, b, op=op)
                                   for a, b in zip(dims, dims[1:]))

    def flax_tree(self):
        tree = {f"CompConv_{i}": conv for i, conv in enumerate(self.convs)}
        tree["rel_emb"] = self.rel_emb
        return tree

    def forward(self, x, edge_index, edge_type, num_nodes=None):
        if isinstance(self.rel_emb, UninitializedParameter):
            with torch.inference_mode(False), torch.no_grad():
                self.rel_emb.materialize((self.num_relations, x.shape[-1]),
                                         device=x.device)
                glorot_uniform_(self.rel_emb)
        rel = self.rel_emb
        for i, conv in enumerate(self.convs):
            x, rel = conv(x, edge_index, edge_type, rel, num_nodes)
            if i < len(self.convs) - 1:
                x = F.relu(x)
        return x


class DGCNNModel(nn.Module):
    """Graph classification by sort pooling (Zhang et al. 2018):
    ``num_layers`` tanh EdgeConvs of ``hidden_dim`` and a 1-channel one
    whose output is the sort key (``EdgeConv_0`` ... ``EdgeConv_{L}``),
    their outputs concatenated and sort-pooled to the ``k`` top rows of
    each graph, then a width-3 convolution of 16 channels along the rows
    (flax ``Conv_0``: 'SAME' padding, stride 1), ReLU, a max pool of
    window 2 and stride 2 ('VALID'), flattened row-major as flax
    flattens (rows, channels), and two maps (``Dense_0`` to 128, ReLU,
    ``Dense_1`` to ``num_class``)."""

    def __init__(self, hidden_dim=32, num_class=2, num_layers=3, k=30,
                 in_channels=None):
        super().__init__()
        self.k = k
        dims = [in_channels] + [hidden_dim] * num_layers
        self.convs = nn.ModuleList(
            [EdgeConv(a, b) for a, b in zip(dims, dims[1:])]
            + [EdgeConv(hidden_dim, 1)])
        width = hidden_dim * num_layers + 1
        self.conv1d = nn.Conv1d(width, 16, kernel_size=3, padding=1)
        # flax's Conv defaults: a lecun-normal kernel over its fan-in of
        # width x channels, a zero bias
        fan_in_normal_(self.conv1d.weight.view(16, -1), 1.0)
        nn.init.zeros_(self.conv1d.bias)
        self.lin1 = lecun_dense(16 * (k // 2), 128)
        self.lin2 = lecun_dense(128, num_class)

    def flax_tree(self):
        tree = {f"EdgeConv_{i}": conv for i, conv in enumerate(self.convs)}
        tree.update({"Conv_0": self.conv1d, "Dense_0": self.lin1,
                     "Dense_1": self.lin2})
        return tree

    def forward(self, x, edge_index, batch=None, num_graphs=None,
                num_nodes=None):
        hs = []
        for conv in self.convs[:-1]:
            x = torch.tanh(conv(x, edge_index, num_nodes))
            hs.append(x)
        key = torch.tanh(self.convs[-1](x, edge_index, num_nodes))
        h = torch.cat(hs + [key], dim=-1)
        pooled = global_sort_pool(h, batch, self.k, num_graphs=num_graphs)
        B = pooled.shape[0]
        seq = pooled.reshape(B, self.k, h.shape[-1]).transpose(1, 2)
        seq = F.max_pool1d(F.relu(self.conv1d(seq)), 2, 2)
        seq = seq.transpose(1, 2).reshape(B, -1)
        return lecun_apply(self.lin2, F.relu(lecun_apply(self.lin1, seq)))


class GaANModel(nn.Module):
    """``num_layers`` GaANConvs of ``heads`` heads (``GaANConv_{i}``),
    ReLU between them, the last mapping to ``num_class``. No dropout, as
    in the JAX model (which takes ``train`` and ignores it)."""

    def __init__(self, hidden_dim=16, num_class=7, heads=4, num_layers=2,
                 in_channels=None):
        super().__init__()
        dims = [in_channels] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.convs = nn.ModuleList(GaANConv(a, b, heads=heads)
                                   for a, b in zip(dims, dims[1:]))

    def flax_tree(self):
        return {f"GaANConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, num_nodes=None):
        for conv in self.convs[:-1]:
            x = F.relu(conv(x, edge_index, num_nodes))
        return self.convs[-1](x, edge_index, num_nodes)
