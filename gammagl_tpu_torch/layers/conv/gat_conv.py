"""GATConv (Velickovic et al. 2018) and GATV2Conv (Brody et al. 2022),
counterparts of `gammagl_tpu/layers/conv/gat_conv.py`.

Edge score a . [W x_src || W x_dst], LeakyReLU, per-destination softmax,
multi-head weighted sum. Two paths compute the same function:

* with a `CSRPlan` (``plan=graph.csr_plan()``): GAT's additive score
  splits per endpoint, so the per-node scores and features go to
  `flash_gat_attention`, one fused kernel per call on the card (the
  kernel gathers the source rows and reads ``keep`` through the plan's
  ``perm`` itself). Both endpoint scores come from x, the source rows: on
  a relation between two node types (``num_nodes`` != N), destination d
  takes the score of x's row min(d, N - 1) on both paths, as in the JAX
  layer's COO path (the JAX plan path raises where N exceeds its padded
  destination rows: ROADMAP C14);
* without one: the COO path, `segment_softmax` and `bspmm` in plain
  PyTorch, which is also the plain version the card compares against.

Attention dropout scales alpha after the softmax. In training it takes
``keep`` (E, H) in the caller's edge order when one is given, else draws
one from ``generator``; both paths take the same ``keep``.

GATV2Conv's score a . leaky_relu(W_l x_src + W_r x_dst) does not split per
endpoint, so its plan path builds per-edge rows: the source side by
`gather_rows` (plain indexing; its backward is the SpMM kernel), the
destination side by `expand_dst_csr` (the expand kernel; its backward the
per-edge segment sum), the scores in plain PyTorch, and softmax and sum in
one `flash_softmax_spmm_mh` kernel over rows in CSR order.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.dense import dense, glorot_uniform_
from gammagl_tpu_torch.ops import (bspmm, expand_dst_csr, flash_gat_attention,
                                   flash_softmax_spmm_mh, gather_rows,
                                   segment_softmax)
from gammagl_tpu_torch.ops.cuda import attention_keep_mask
from gammagl_tpu_torch.utils.compute_dtype import resolve_dtype

__all__ = ["GATConv", "GATV2Conv"]


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
            if a_dst.shape[0] != plan.num_nodes:
                # a relation between two node types (HANConv): the COO
                # route scores destination d by x's row min(d, N - 1), the
                # JAX layer's clipped gather, so this route does too
                rows = torch.arange(plan.num_nodes, device=a_dst.device)
                a_dst = a_dst[rows.clamp(max=a_dst.shape[0] - 1)]
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


class GATV2Conv(MessagePassing):
    """GATv2 attention layer: score a . leaky_relu(W_l x_src + W_r x_dst).

    Parameters, float32 and named as in flax: ``lin_l`` and, unless
    ``share_weights``, ``lin_r``, bias-free ``nn.Linear`` layers (flax's
    ``Dense_0`` and ``Dense_1``, glorot-uniform); ``att`` (1, H, F),
    truncated_normal(0.02); ``bias`` zeros, (H*F,) when ``concat`` else
    (F,). ``in_channels=None`` makes the linear maps lazy. ``dtype`` is the
    compute dtype (None: the process default of `utils.compute_dtype`,
    else the inputs' promoted dtype, as flax's ``Dense``).

    Attention dropout (training mode, ``dropout_rate > 0``): ``keep``
    (E, H), when given, is in the caller's edge order on both paths (as
    for `GATConv`); the plan path carries it into CSR order. A mask drawn
    from ``generator`` is drawn in the plan's CSR order (edges stably
    sorted by destination) on both paths, so the plan path reads it as
    drawn, with no reorder, and the COO path scatters it into edge order:
    one generator state gives both paths the same mask.
    """

    def __init__(self, in_channels, out_channels, heads=1, concat=True,
                 negative_slope=0.2, dropout_rate=0.0, add_bias=True,
                 share_weights=False, dtype=None):
        super().__init__()
        self.out_channels = out_channels
        self.heads = heads
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout_rate = dropout_rate
        self.share_weights = share_weights
        self.dtype = dtype
        width = heads * out_channels

        def linear():
            return (nn.LazyLinear(width, bias=False) if in_channels is None
                    else nn.Linear(in_channels, width, bias=False))

        self.lin_l = linear()
        self.lin_r = None if share_weights else linear()
        self.att = nn.Parameter(torch.empty(1, heads, out_channels))
        self.bias = (nn.Parameter(torch.zeros(width if concat
                                              else out_channels))
                     if add_bias else None)
        self.reset_parameters()

    def _linears(self):
        return [lin for lin in (self.lin_l, self.lin_r) if lin is not None]

    def reset_parameters(self):
        """glorot_uniform kernels, truncated_normal(0.02) ``att`` and zero
        bias: the flax initialisers."""
        for lin in self._linears():
            if not isinstance(lin.weight, UninitializedParameter):
                nn.init.xavier_uniform_(lin.weight)
        truncated_normal_(self.att)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def flax_tree(self):
        tree = {"Dense_0": self.lin_l, "att": self.att}
        if self.lin_r is not None:
            tree["Dense_1"] = self.lin_r
        if self.bias is not None:
            tree["bias"] = self.bias
        return tree

    def _keep(self, keep, generator, edge_index, plan, device):
        """keep (E, H) float32 in the order the path reads, or None."""
        if not self.training or self.dropout_rate == 0:
            return None
        if keep is not None:  # the caller's edge order
            keep = keep.float()
            return keep if plan is None else keep[plan.arrays(device)[2]]
        E = edge_index.shape[1]
        csr = attention_keep_mask(generator, self.dropout_rate,
                                  (E, self.heads), device=device)
        if plan is not None:
            return csr
        perm = torch.argsort(edge_index[1], stable=True)
        return torch.empty_like(csr).index_copy_(0, perm, csr)

    def forward(self, x, edge_index, num_nodes=None, plan=None, keep=None,
                generator=None):
        """x (N, in) -> (N, H*F) when ``concat`` else (N, F). ``keep``
        (E, H) and ``generator`` are read in training mode only."""
        H, Fo = self.heads, self.out_channels
        if num_nodes is None:
            num_nodes = x.shape[0]
        dtype = resolve_dtype(self.dtype)
        x_l = dense(self.lin_l, x, dtype, glorot_uniform_)
        x_r = (x_l if self.lin_r is None
               else dense(self.lin_r, x, dtype, glorot_uniform_))
        att = self.att if dtype is None else self.att.to(dtype)
        keep = self._keep(keep, generator, edge_index, plan, x.device)
        if plan is not None:
            g_l = gather_rows(x_l, plan, "src")
            g_r = expand_dst_csr(x_r, plan)
            feat = F.leaky_relu((g_l + g_r).view(-1, H, Fo),
                                self.negative_slope)
            e = torch.einsum("ehf,hf->eh", feat, att[0])
            out = flash_softmax_spmm_mh(e, g_l.view(-1, H, Fo), plan, keep)
        else:
            n = x_l.shape[0]
            src = edge_index[0].long().clamp(0, n - 1)
            dst = edge_index[1].long()
            feat = (x_l.view(n, H, Fo)[src]
                    + x_r.view(n, H, Fo)[dst.clamp(0, n - 1)])
            e = (F.leaky_relu(feat, self.negative_slope) * att).sum(-1)
            alpha = segment_softmax(e, dst, num_nodes)
            if keep is not None:
                alpha = alpha * keep.to(alpha.dtype)
            out = bspmm(edge_index, alpha, x_l.view(n, H, Fo),
                        num_nodes=num_nodes)
        out = out.reshape(-1, H * Fo) if self.concat else out.mean(1)
        if self.bias is not None:
            out = out + self.bias
        return out
