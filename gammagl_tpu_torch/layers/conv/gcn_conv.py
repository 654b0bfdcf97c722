"""GCNConv (Kipf & Welling 2017), counterpart of
`gammagl_tpu/layers/conv/gcn_conv.py`.

Norm modes 'left' | 'right' | 'both' | 'none': degree-normalised edge
weights from the src/dst degrees, a bias-free linear map, then a fused
SpMM propagate, then the bias.
"""

import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.dense import dense, glorot_uniform_
from gammagl_tpu_torch.ops.segment import segment_count
from gammagl_tpu_torch.utils.compute_dtype import resolve_dtype

__all__ = ["GCNConv"]

_NORMS = ("left", "right", "both", "none")


def _degree_norm(ids, num_nodes, norm):
    """deg^-1/2 ('both') or 1/deg per node, 0 for isolated nodes. Degrees
    are counted in float32, so they stay exact under a bfloat16 compute
    dtype."""
    deg = segment_count(ids, num_nodes)
    scale = deg.rsqrt() if norm == "both" else deg.reciprocal()
    return scale.masked_fill_(deg == 0, 0.0)


class GCNConv(MessagePassing):
    """Graph convolution.

    Parameters: ``linear`` (an ``nn.Linear(in, out, bias=False)``, flax's
    ``Dense_0``) and ``bias`` (out,), both float32. ``in_channels=None``
    makes the linear map lazy: its in-features come from the first input
    or from `load_jax_params`. ``dtype`` is the compute dtype (None: the
    process default of `utils.compute_dtype`, else float32).
    """

    def __init__(self, in_channels, out_channels, norm="both", add_bias=True,
                 dtype=None):
        super().__init__()
        if norm not in _NORMS:
            raise ValueError(f"invalid norm {norm!r}")
        self.norm = norm
        self.dtype = dtype
        self.linear = (nn.LazyLinear(out_channels, bias=False)
                       if in_channels is None
                       else nn.Linear(in_channels, out_channels, bias=False))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if add_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self):
        """Glorot-uniform kernel and zero bias, the flax initialisers."""
        if not isinstance(self.linear.weight, UninitializedParameter):
            nn.init.xavier_uniform_(self.linear.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def flax_tree(self):
        tree = {"Dense_0": self.linear}
        if self.bias is not None:
            tree["bias"] = self.bias
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        x = dense(self.linear, x, resolve_dtype(self.dtype), glorot_uniform_)
        src, dst = edge_index[0].long(), edge_index[1].long()
        weights = (torch.ones(edge_index.shape[1], device=x.device)
                   if edge_weight is None else edge_weight.float())
        # the norms are gathered as JAX gathers, clamped: a padded edge
        # (ids == num_nodes, `data.pad_graph`) reads the last node's norm,
        # and its destination is dropped by the sum
        if self.norm in ("left", "both"):
            weights = _degree_norm(src, num_nodes, self.norm)[
                src.clamp(0, num_nodes - 1)] * weights
        if self.norm in ("right", "both"):
            weights = weights * _degree_norm(dst, num_nodes, self.norm)[
                dst.clamp(0, num_nodes - 1)]
        # round the weights to the JAX layer's dtype (its norms are in x's,
        # promoted with the caller's weights), so the COO spmm gives its
        # output dtype; the degrees above stay float32
        wdtype = x.dtype if edge_weight is None else edge_weight.dtype
        if self.norm != "none":
            wdtype = torch.promote_types(x.dtype, wdtype)
        weights = weights.to(wdtype)
        out = self.propagate(x, edge_index, edge_weight=weights,
                             num_nodes=num_nodes, plan=plan)
        if self.bias is not None:
            out = out + self.bias
        return out
