"""SAGEConv (Hamilton et al. 2017), counterpart of
`gammagl_tpu/layers/conv/sage_conv.py`.

``W_self x_dst + W_neigh agg_{j in N(i)} x_j`` with the 'mean', 'gcn'
(symmetric-normalised sum, no self term), 'pool' and 'max' (max of
ReLU(W_pool x_j)) aggregators, and bipartite ``(x_src, x_dst)`` inputs for
sampled blocks. With a `CSRPlan` every aggregation runs a kernel on the
card: 'mean' and 'gcn' the CSR SpMM, 'pool' and 'max' the segment max.

The JAX layer drops the plan on the pool/max branch (it calls `propagate`
without it, `sage_conv.py:54-55`); the port passes it. The function is the
same, since a max is exact in any order and rows without edges are 0 on
both routes (ROADMAP C4).
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.dense import dense, fan_in_normal_
from gammagl_tpu_torch.ops.segment import segment_count
from gammagl_tpu_torch.utils.compute_dtype import resolve_dtype

__all__ = ["SAGEConv"]

_AGGRS = ("mean", "gcn", "pool", "max")


def he_normal_(weight):
    """flax's ``he_normal``, the JAX layer's kernel init."""
    return fan_in_normal_(weight, 2.0)


class SAGEConv(MessagePassing):
    """GraphSAGE layer.

    Parameters, float32 and named as in flax: ``lin_neigh`` (``Dense_0``,
    in_src -> out), on the pool/max branch ``lin_pool`` (``Dense_1``, in_src
    -> in_src), and unless ``aggr='gcn'`` ``lin_self`` (``Dense_1``, or
    ``Dense_2`` after the pool layer; in_dst -> out), all bias-free
    ``nn.Linear`` with he-normal kernels; ``bias`` (out,) zeros.
    ``in_channels`` is an int, a (src, dst) pair, or None for lazy layers
    whose in-features come from the first input or `load_jax_params`.
    ``dtype`` is the compute dtype (None: the process default of
    `utils.compute_dtype`, else the inputs' promoted dtype, as flax's
    ``Dense``).
    """

    def __init__(self, in_channels, out_channels, aggr="mean", add_bias=True,
                 dtype=None):
        super().__init__()
        if aggr not in _AGGRS:
            raise ValueError(f"unknown aggr {aggr!r}")
        self.out_channels = out_channels
        self.aggr = aggr
        self.dtype = dtype
        in_src, in_dst = (in_channels if isinstance(in_channels, tuple)
                          else (in_channels, in_channels))

        def linear(fan_in, fan_out):
            if fan_in is None:  # fan_out 0: the pool layer, sized later
                return nn.LazyLinear(fan_out or 0, bias=False)
            return nn.Linear(fan_in, fan_out or fan_in, bias=False)

        self.lin_neigh = linear(in_src, out_channels)
        self.lin_pool = (linear(in_src, None) if aggr in ("pool", "max")
                         else None)
        self.lin_self = linear(in_dst, out_channels) if aggr != "gcn" else None
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if add_bias
                     else None)
        for lin in self._linears():
            if not isinstance(lin.weight, UninitializedParameter):
                he_normal_(lin.weight)

    def _linears(self):
        return [lin for lin in (self.lin_neigh, self.lin_pool, self.lin_self)
                if lin is not None]

    def flax_tree(self):
        names = iter(f"Dense_{i}" for i in range(3))
        tree = {next(names): lin for lin in self._linears()}
        if self.bias is not None:
            tree["bias"] = self.bias
        return tree

    @staticmethod
    def _dense(lin, x, dtype):
        return dense(lin, x, dtype, he_normal_)

    def forward(self, feat, edge_index, num_nodes=None, plan=None):
        """feat (N, in) or (x_src, x_dst) -> (N_dst, out)."""
        src_feat, dst_feat = feat if isinstance(feat, tuple) else (feat, feat)
        if num_nodes is None:
            num_nodes = dst_feat.shape[0]
        dtype = resolve_dtype(self.dtype)
        if self.aggr == "mean":
            out = self.propagate(self._dense(self.lin_neigh, src_feat, dtype),
                                 edge_index, aggr="mean",
                                 num_nodes=num_nodes, plan=plan)
        elif self.aggr == "gcn":
            h = self._dense(self.lin_neigh, src_feat, dtype)
            src, dst = edge_index[0].long(), edge_index[1].long()
            deg_src = segment_count(src, src_feat.shape[0])
            deg_dst = segment_count(dst, num_nodes)
            w = (deg_src.rsqrt().masked_fill_(deg_src == 0, 0.0)[src]
                 * deg_dst.rsqrt().masked_fill_(deg_dst == 0, 0.0)[dst]
                 ).to(h.dtype)  # the JAX layer's weights are in h's dtype
            out = self.propagate(h, edge_index, edge_weight=w,
                                 num_nodes=num_nodes, plan=plan)
        else:
            h = F.relu(self._dense(self.lin_pool, src_feat, dtype))
            out = self.propagate(h, edge_index, aggr="max",
                                 num_nodes=num_nodes, plan=plan)
            out = self._dense(self.lin_neigh, out, dtype)
        if self.lin_self is not None:
            out = out + self._dense(self.lin_self, dst_feat, dtype)
        if self.bias is not None:
            out = out + self.bias
        return out
