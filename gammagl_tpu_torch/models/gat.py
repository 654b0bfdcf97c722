"""GAT and GATv2 models, counterparts of `gammagl_tpu/models/gat.py`."""

import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GATConv, GATV2Conv
from gammagl_tpu_torch.layers.dense import dropout

__all__ = ["GATModel", "GATV2Model", "dropout"]


class GATModel(nn.Module):
    """Two GATConvs (Velickovic et al. 2018): ``heads`` heads of
    ``hidden_dim`` concatenated, ELU, then one head of ``num_class``
    averaged. Input dropout and attention dropout at ``drop_rate`` before
    and inside each layer, active in training mode only.

    ``dtype`` is the compute dtype; parameters stay float32. The first
    layer's in-features come from ``in_channels``, the first input or
    `load_jax_params`. In training, ``keeps`` (one (E, H) attention mask
    a layer, in the caller's edge order) and ``generator`` make the
    dropout reproducible across the plan and COO paths.
    """

    def __init__(self, hidden_dim=8, num_class=7, heads=8, drop_rate=0.6,
                 dtype=None, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList([
            GATConv(in_channels, hidden_dim, heads=heads,
                    dropout_rate=drop_rate, dtype=dtype),
            GATConv(hidden_dim * heads, num_class, heads=1, concat=False,
                    dropout_rate=drop_rate, dtype=dtype)])

    def flax_tree(self):
        return {f"GATConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, num_nodes=None, plan=None, keeps=None,
                generator=None):
        rate = self.drop_rate if self.training else 0.0
        keeps = keeps if keeps is not None else (None, None)
        x = dropout(x, rate, generator)
        x = self.convs[0](x, edge_index, num_nodes, plan=plan,
                          keep=keeps[0], generator=generator)
        x = dropout(F.elu(x), rate, generator)
        return self.convs[1](x, edge_index, num_nodes, plan=plan,
                             keep=keeps[1], generator=generator)


class GATV2Model(nn.Module):
    """Two GATV2Convs (Brody et al. 2022): ``heads`` heads of
    ``hidden_dim`` concatenated, ELU, then one head of ``num_class``
    averaged; input and attention dropout at ``drop_rate``, in training
    mode only. Flax names ``GATV2Conv_0`` and ``GATV2Conv_1``.

    Like the JAX model it has no ``dtype``: the layers compute in the
    process default of `utils.compute_dtype`. ``keeps`` (one (E, H) mask a
    layer, in the caller's edge order) and ``generator`` as for
    `GATModel`; a mask drawn from ``generator`` is drawn in CSR order (see
    `GATV2Conv`).
    """

    def __init__(self, hidden_dim=8, num_class=7, heads=8, drop_rate=0.6,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList([
            GATV2Conv(in_channels, hidden_dim, heads=heads,
                      dropout_rate=drop_rate),
            GATV2Conv(hidden_dim * heads, num_class, heads=1, concat=False,
                      dropout_rate=drop_rate)])

    def flax_tree(self):
        return {f"GATV2Conv_{i}": conv for i, conv in enumerate(self.convs)}

    forward = GATModel.forward
