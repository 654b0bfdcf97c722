"""GATConv (Velickovic et al. 2018), counterpart of
`gammagl_tpu/layers/conv/gat_conv.py`.

Edge score a . [W x_src || W x_dst], LeakyReLU, per-destination softmax,
multi-head weighted sum. Two paths compute the same function:

* with a `CSRPlan` (``plan=graph.csr_plan()``): GAT's additive score
  splits per endpoint, so the per-node scores and features go to
  `flash_gat_attention`, one fused kernel per call on the card (the
  kernel gathers the source rows and reads ``keep`` through the plan's
  ``perm`` itself);
* without one: the COO path, `segment_softmax` and `bspmm` in plain
  PyTorch, which is also the plain version the card compares against.

Attention dropout scales alpha after the softmax. In training it takes
``keep`` (E, H) in the caller's edge order when one is given, else draws
one from ``generator``; both paths take the same ``keep``.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.ops import bspmm, flash_gat_attention, segment_softmax
from gammagl_tpu_torch.ops.cuda import attention_keep_mask
from gammagl_tpu_torch.utils.compute_dtype import resolve_dtype

__all__ = ["GATConv"]


def truncated_normal_(t, stddev=0.02):
    """flax's ``truncated_normal(stddev)``: a unit normal cut at +-2, times
    ``stddev``."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0).mul_(stddev)


class GATConv(MessagePassing):
    """Graph attention layer.

    Parameters, float32 and named as in flax: ``w`` (in, H*F), a raw
    matrix with no transpose; ``att`` (1, H, 2F), the source half first;
    ``bias`` (H*F,) when ``concat`` else (F,). ``in_channels=None`` makes
    ``w`` lazy: its rows come from the first input or from
    `load_jax_params`. ``dtype`` is the compute dtype (None: the process
    default of `utils.compute_dtype`, else the inputs' promoted dtype).
    """

    def __init__(self, in_channels, out_channels, heads=1, concat=True,
                 negative_slope=0.2, dropout_rate=0.0, add_bias=True,
                 dtype=None):
        super().__init__()
        self.out_channels = out_channels
        self.heads = heads
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        width = heads * out_channels
        self.w = (UninitializedParameter() if in_channels is None
                  else nn.Parameter(torch.empty(in_channels, width)))
        self.att = nn.Parameter(torch.empty(1, heads, 2 * out_channels))
        self.bias = (nn.Parameter(torch.empty(width if concat
                                              else out_channels))
                     if add_bias else None)
        self.reset_parameters()

    def reset_parameters(self):
        """truncated_normal(0.02) for every parameter, the flax
        initialisers."""
        for p in (self.w, self.att, self.bias):
            if p is not None and not isinstance(p, UninitializedParameter):
                truncated_normal_(p)

    def flax_tree(self):
        tree = {"w": self.w, "att": self.att}
        if self.bias is not None:
            tree["bias"] = self.bias
        return tree

    def _project(self, x, dtype):
        if isinstance(self.w, UninitializedParameter):
            with torch.inference_mode(False), torch.no_grad():
                self.w.materialize((x.shape[-1],
                                    self.heads * self.out_channels))
                truncated_normal_(self.w)
        w, att = self.w, self.att
        if dtype is None:  # flax promotes the input and the kernel
            dtype = torch.promote_types(x.dtype, w.dtype)
        return x.to(dtype) @ w.to(dtype), att.to(dtype)

    def _keep(self, keep, generator, E, device):
        if not self.training or self.dropout_rate == 0:
            return None
        if keep is None:
            keep = attention_keep_mask(generator, self.dropout_rate,
                                       (E, self.heads), device=device)
        return keep

    def forward(self, x, edge_index, num_nodes=None, plan=None, keep=None,
                generator=None):
        """x (N, in) -> (N, H*F) when ``concat`` else (N, F). ``keep``
        (E, H) and ``generator`` are read in training mode only."""
        H, Fo = self.heads, self.out_channels
        if num_nodes is None:
            num_nodes = x.shape[0]
        h, att = self._project(x, resolve_dtype(self.dtype))
        h = h.reshape(-1, H, Fo)
        keep = self._keep(keep, generator, edge_index.shape[1], x.device)
        if plan is not None:
            s_src = torch.einsum("nhf,hf->nh", h, att[0, :, :Fo])
            a_dst = torch.einsum("nhf,hf->nh", h, att[0, :, Fo:])
            out = flash_gat_attention(s_src, a_dst, h, plan,
                                      self.negative_slope, keep)
        else:
            src = edge_index[0].long().clamp(0, h.shape[0] - 1)
            dst = edge_index[1].long()
            feat = torch.cat([h[src], h[dst.clamp(0, h.shape[0] - 1)]], -1)
            e = F.leaky_relu((feat * att).sum(-1), self.negative_slope)
            alpha = segment_softmax(e, dst, num_nodes)
            if keep is not None:
                alpha = alpha * keep.to(alpha.dtype)
            out = bspmm(edge_index, alpha, h, num_nodes=num_nodes)
        out = out.reshape(-1, H * Fo) if self.concat else out.mean(1)
        if self.bias is not None:
            out = out + self.bias
        return out
