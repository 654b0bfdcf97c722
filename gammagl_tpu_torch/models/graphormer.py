"""Graphormer (Ying et al. 2021) for graph-level prediction (counterpart
of `gammagl_tpu/models/graphormer.py`; reference:
gammagl/models/graphormer.py): centrality and spatial encodings, stacked
dense-attention layers, a mean readout. No kernel: each graph's attention
is a dense softmax in plain PyTorch, as in JAX.
"""

from torch import nn

from gammagl_tpu_torch.layers.attention.graphormer import (
    CentralityEncoder, GraphormerLayer, SpatialEncoder)
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense

__all__ = ["GraphormerModel"]


class GraphormerModel(nn.Module):
    """One graph (or a padded member of a batch, ``mask`` its real nodes)
    -> (num_class,) logits. flax names: ``Dense_0`` (the input map),
    ``CentralityEncoder_0``, ``SpatialEncoder_0``, ``GraphormerLayer_{i}``,
    ``LayerNorm_0``, ``Dense_1`` (the head). ``in_channels=None`` leaves
    the input map lazy."""

    def __init__(self, hidden_dim=80, num_class=1, num_layers=4, num_heads=8,
                 max_degree=64, max_dist=5, dropout_rate=0.1,
                 in_channels=None):
        super().__init__()
        self.lin_in = lecun_dense(in_channels, hidden_dim)
        self.centrality = CentralityEncoder(max_degree, hidden_dim)
        self.spatial = SpatialEncoder(max_dist, num_heads)
        self.layers = nn.ModuleList(
            GraphormerLayer(hidden_dim, num_heads, dropout_rate=dropout_rate)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.lin_in, "CentralityEncoder_0": self.centrality,
                "SpatialEncoder_0": self.spatial, "LayerNorm_0": self.norm,
                "Dense_1": self.head}
        tree.update({f"GraphormerLayer_{i}": layer
                     for i, layer in enumerate(self.layers)})
        return tree

    def forward(self, x, in_degree, out_degree, dist, mask=None,
                generator=None):
        """x (N, F), degrees (N,), dist (N, N) hop distances (-1:
        unreachable), mask (N,) bool or None."""
        h = self.centrality(lecun_apply(self.lin_in, x), in_degree,
                            out_degree)
        bias = self.spatial(dist)
        for layer in self.layers:
            h = layer(h, attn_bias=bias, mask=mask, generator=generator)
        h = self.norm(h)
        if mask is not None:
            denom = mask.sum().clamp_min(1)
            pooled = (h * mask[:, None]).sum(0) / denom
        else:
            pooled = h.mean(0)
        return lecun_apply(self.head, pooled)
