"""The propagation zoo: SGC, GIN, APPNP, GCNII, Chebyshev, AGNN, FAGCN,
GPR-GNN and MixHop convolutions, and jumping knowledge (counterparts of
`gammagl_tpu/layers/conv/simple_convs.py`).

Every conv but `JumpingKnowledge` sums its messages through
`MessagePassing.propagate` with the caller's ``plan``: with a `CSRPlan`
on the card each hop is one launch of the CSR SpMM kernel (`spmm_csr`),
and a hop whose edge weights carry a gradient (AGNN's attention, FAGCN's
gates) takes their gradient from the SDDMM kernel; without a plan the COO
`spmm` runs. Degrees are counted in float32 (ROADMAP C1) and gathered
clamped, as the JAX package gathers.
"""

import torch
from torch import nn

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.dense import (dense, dropout, glorot_dense,
                                            glorot_uniform_, lecun_dense,
                                            lecun_normal_)
from gammagl_tpu_torch.ops.sddmm import sddmm_dot
from gammagl_tpu_torch.ops.segment import segment_count
from gammagl_tpu_torch.ops.softmax import segment_softmax
from gammagl_tpu_torch.utils.norm import calc_gcn_norm

__all__ = ["SGConv", "GINConv", "APPNPConv", "GCNIIConv", "ChebConv",
           "AGNNConv", "FAGCNConv", "GPRConv", "MixHopConv",
           "JumpingKnowledge"]


def _glorot(lin, x):
    """flax ``Dense`` with a glorot-uniform kernel, applied to x."""
    return dense(lin, x, None, glorot_uniform_)


def _dis(dst, num_nodes, edge_index):
    """deg(dst)^-1/2 of each edge's source and destination, 0 for an
    isolated node: two (E,) float32 tensors."""
    deg = segment_count(dst, num_nodes)
    dis = torch.where(deg > 0, deg.pow(-0.5), 0.0)
    last = max(num_nodes - 1, 0)
    return (dis[edge_index[0].long().clamp(0, last)],
            dis[edge_index[1].long().clamp(0, last)])


def _gcn_weights(edge_index, num_nodes, edge_weight, dtype):
    """Symmetric degree-normalised weights w_e / sqrt(deg(s) deg(d)) in
    x's dtype (promoted with the caller's weights)."""
    d_src, d_dst = _dis(edge_index[1].long(), num_nodes, edge_index)
    if edge_weight is None:
        return (d_src * d_dst).to(dtype)
    return (d_src * edge_weight.float() * d_dst).to(
        torch.promote_types(dtype, edge_weight.dtype))


class SGConv(MessagePassing):
    """Simplified GCN (Wu et al. 2019): A_hat^k (X W + b), the map first
    (flax ``Dense_0``, glorot kernel, zero bias), then ``itera_k`` hops
    with symmetric degree norm."""

    def __init__(self, in_channels, out_channels, itera_k=2):
        super().__init__()
        self.itera_k = itera_k
        self.linear = glorot_dense(in_channels, out_channels)

    def flax_tree(self):
        return {"Dense_0": self.linear}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        x = _glorot(self.linear, x)
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        for _ in range(self.itera_k):
            x = self.propagate(x, edge_index, edge_weight=w,
                               num_nodes=num_nodes, plan=plan)
        return x


class GINConv(MessagePassing):
    """GIN (Xu et al. 2019): ``apply_func((1 + eps) x + sum_j x_j)``.

    ``eps`` is a learned scalar (flax ``eps``) when ``learn_eps``, else
    the constant ``init_eps``. ``apply_func`` (a module, or None) is held
    here but, as in flax, its parameters belong to the model that built
    it: `GINModel` names them in its own tree.
    """

    def __init__(self, apply_func=None, init_eps=0.0, learn_eps=False):
        super().__init__()
        self.apply_func = apply_func
        self.eps = (nn.Parameter(torch.tensor(float(init_eps))) if learn_eps
                    else float(init_eps))

    def flax_tree(self):
        return {"eps": self.eps} if isinstance(self.eps, nn.Parameter) \
            else {}

    def forward(self, x, edge_index, num_nodes=None, plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        agg = self.propagate(x, edge_index, num_nodes=num_nodes, plan=plan)
        out = (1 + self.eps) * x + agg
        return out if self.apply_func is None else self.apply_func(out)


class APPNPConv(MessagePassing):
    """Approximate personalised PageRank (Klicpera et al. 2019):
    ``itera_k`` steps of h <- (1 - alpha) A_hat h + alpha h0. In training
    mode with ``edge_dropout`` > 0 each step drops the normalised edge
    weights anew, drawn from ``generator`` on its own device. No
    parameters."""

    def __init__(self, itera_k=10, alpha=0.1, edge_dropout=0.0):
        super().__init__()
        self.itera_k, self.alpha = itera_k, alpha
        self.edge_dropout = edge_dropout

    def flax_tree(self):
        return {}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        rate = self.edge_dropout if self.training else 0.0
        h0 = x
        for _ in range(self.itera_k):
            wk = dropout(w, rate, generator)
            x = ((1 - self.alpha)
                 * self.propagate(x, edge_index, edge_weight=wk,
                                  num_nodes=num_nodes, plan=plan)
                 + self.alpha * h0)
        return x


class GCNIIConv(MessagePassing):
    """GCNII (Chen et al. 2020): initial residual and identity mapping,
    h = (1 - alpha) A_hat x + alpha x0, out = (1 - beta) h + beta h W.
    ``variant`` maps the concatenation [(1 - alpha) A_hat x, alpha x0]
    instead of h. The map is bias-free with a glorot kernel; flax names
    it ``Dense_0``, or ``Dense_1`` with ``variant`` (the JAX layer there
    creates a ``Dense_0`` it never calls, which holds no parameters).
    ``in_channels`` is x's width (None: lazy); ``out_channels`` must equal
    it, for the residual. Without ``edge_weight`` the weights are
    `calc_gcn_norm`'s."""

    def __init__(self, in_channels, out_channels, beta=0.1, alpha=0.1,
                 variant=False):
        super().__init__()
        self.beta, self.alpha, self.variant = beta, alpha, variant
        fan_in = (None if in_channels is None
                  else in_channels * (2 if variant else 1))
        self.linear = glorot_dense(fan_in, out_channels, bias=False)

    def flax_tree(self):
        return {"Dense_1" if self.variant else "Dense_0": self.linear}

    def forward(self, x, x0, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if edge_weight is None:
            edge_weight = calc_gcn_norm(edge_index, num_nodes)
        agg = self.propagate(x, edge_index, edge_weight=edge_weight,
                             num_nodes=num_nodes, plan=plan)
        h = (1 - self.alpha) * agg + self.alpha * x0
        support = (torch.cat([(1 - self.alpha) * agg, self.alpha * x0], -1)
                   if self.variant else h)
        return (1 - self.beta) * h + self.beta * _glorot(self.linear,
                                                         support)


class ChebConv(MessagePassing):
    """Chebyshev spectral convolution (Defferrard et al. 2016): sum_k
    T_k(L~) x W_k + b with the scaled Laplacian L~ = 2 L / lambda_max - I,
    L = I - D^-1/2 A D^-1/2: its off-diagonal -2 w_sym / lambda_max goes
    through ``propagate``, its diagonal 2 / lambda_max - 1 (0 at the
    default lambda_max of 2, kept as in the JAX layer) is added. ``K``
    bias-free glorot maps (flax ``Dense_0`` ... ``Dense_{K-1}``) and a
    zero ``bias``. ``normalization`` is kept as the JAX layer keeps it
    (only 'sym' is computed)."""

    def __init__(self, in_channels, out_channels, K=3, normalization="sym"):
        super().__init__()
        self.K, self.normalization = K, normalization
        self.lins = nn.ModuleList(glorot_dense(in_channels, out_channels,
                                          bias=False) for _ in range(K))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def flax_tree(self):
        tree = {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}
        tree["bias"] = self.bias
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                lambda_max=2.0, plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = -_gcn_weights(edge_index, num_nodes, edge_weight,
                          x.dtype) * (2.0 / lambda_max)
        diag = 2.0 / lambda_max - 1.0

        def hop(h):
            return self.propagate(h, edge_index, edge_weight=w,
                                  num_nodes=num_nodes, plan=plan) + diag * h

        tx_0 = x
        out = _glorot(self.lins[0], tx_0)
        if self.K > 1:
            tx_1 = hop(x)
            out = out + _glorot(self.lins[1], tx_1)
            for k in range(2, self.K):
                tx_2 = 2 * hop(tx_1) - tx_0
                out = out + _glorot(self.lins[k], tx_2)
                tx_0, tx_1 = tx_1, tx_2
        return out + self.bias


class AGNNConv(MessagePassing):
    """Attention-based GNN (Thekumparampil et al. 2018): attention
    softmax_d(beta cos(x_s, x_d)) over each destination's edges, then the
    weighted sum of x. The rows are normalised as x / (|x| + 1e-12), as in
    the JAX layer; the cosines are the COO `sddmm_dot`, the softmax the
    COO `segment_softmax`, the sum ``propagate`` (the CSR kernel with a
    plan, whose gradient in the attention is the SDDMM kernel). ``beta``
    (flax ``beta``) is learned when ``require_grad``, else the constant
    ``init_beta``."""

    def __init__(self, init_beta=1.0, require_grad=True):
        super().__init__()
        self.beta = (nn.Parameter(torch.tensor(float(init_beta)))
                     if require_grad else float(init_beta))

    def flax_tree(self):
        return {"beta": self.beta} if isinstance(self.beta, nn.Parameter) \
            else {}

    def forward(self, x, edge_index, num_nodes=None, plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        norm = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                    + 1e-12)
        e = self.beta * sddmm_dot(edge_index, norm, norm)
        alpha = segment_softmax(e, edge_index[1], num_nodes)
        return self.propagate(x, edge_index, edge_weight=alpha,
                              num_nodes=num_nodes, plan=plan)


class FAGCNConv(MessagePassing):
    """Frequency-adaptive GCN (Bo et al. 2021): signed gates alpha_e =
    tanh(g . [x_s || x_d]), dropped in training mode at ``drop_rate``
    (drawn from ``generator``), symmetric degree norm, then the weighted
    sum. ``g`` is a bias-free glorot map of 2 x ``hidden_dim`` -> 1 (flax
    ``Dense_0``); x has ``hidden_dim`` columns. The gate is split into its
    source and destination halves and each half scored once a node, so no
    (E, 2F) concatenation is formed; the endpoints are gathered clamped,
    as the JAX layer gathers them."""

    def __init__(self, hidden_dim, drop_rate=0.0):
        super().__init__()
        self.hidden_dim, self.drop_rate = hidden_dim, drop_rate
        self.gate = glorot_dense(2 * hidden_dim, 1, bias=False)

    def flax_tree(self):
        return {"Dense_0": self.gate}

    def forward(self, x, edge_index, num_nodes=None, plan=None,
                generator=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        g = self.gate.weight.to(x.dtype).reshape(2, -1)
        last = x.shape[0] - 1
        src = edge_index[0].long().clamp(0, last)
        dst = edge_index[1].long().clamp(0, last)
        alpha = torch.tanh((x @ g[0])[src] + (x @ g[1])[dst])
        alpha = dropout(alpha, self.drop_rate if self.training else 0.0,
                        generator)
        d_src, d_dst = _dis(edge_index[1].long(), num_nodes, edge_index)
        w = d_src.to(x.dtype) * alpha * d_dst.to(x.dtype)
        return self.propagate(x, edge_index, edge_weight=w,
                              num_nodes=num_nodes, plan=plan)


class GPRConv(MessagePassing):
    """GPR-GNN (Chien et al. 2021): sum_k gamma_k A_hat^k x over k = 0..K
    with learned hop weights ``gamma`` (K + 1,): personalised PageRank's
    alpha (1 - alpha)^k, the last (1 - alpha)^K, for ``weight_init``
    'PPR', else 1 / (K + 1) each."""

    def __init__(self, K=10, alpha=0.1, weight_init="PPR"):
        super().__init__()
        self.K, self.alpha = K, alpha
        if weight_init == "PPR":
            g = alpha * (1 - alpha) ** torch.arange(K + 1,
                                                    dtype=torch.float32)
            g[-1] = (1 - alpha) ** K
        else:
            g = torch.full((K + 1,), 1.0 / (K + 1))
        self.gamma = nn.Parameter(g)

    def flax_tree(self):
        return {"gamma": self.gamma}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        out = self.gamma[0] * x
        h = x
        for k in range(1, self.K + 1):
            h = self.propagate(h, edge_index, edge_weight=w,
                               num_nodes=num_nodes, plan=plan)
            out = out + self.gamma[k] * h
        return out


class MixHopConv(MessagePassing):
    """MixHop (Abu-El-Haija et al. 2019): the concatenation over the
    powers k in ``p`` of A_hat^k x W_k, each W_k bias-free glorot (flax
    ``Dense_0``, ... in the order of ``p``'s powers, ascending); max(p)
    hops in all."""

    def __init__(self, in_channels, out_channels, p=(0, 1, 2)):
        super().__init__()
        self.p = tuple(p)
        self.lins = nn.ModuleList(
            glorot_dense(in_channels, out_channels, bias=False)
            for k in range(max(self.p) + 1) if k in self.p)

    def flax_tree(self):
        return {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        max_p = max(self.p)
        lins = iter(self.lins)
        outs, h = [], x
        for k in range(max_p + 1):
            if k in self.p:
                outs.append(_glorot(next(lins), h))
            if k < max_p:
                h = self.propagate(h, edge_index, edge_weight=w,
                                   num_nodes=num_nodes, plan=plan)
        return torch.cat(outs, -1)


class JumpingKnowledge(nn.Module):
    """Jumping knowledge over the layer outputs ``xs`` (Xu et al. 2018):
    'cat' concatenates them, 'max' takes their elementwise max, 'att'
    blends them by a softmax over layers of one learned score a node and
    layer (flax ``Dense_0``: ``channels`` -> 1 with bias, lecun-normal;
    None: lazy)."""

    def __init__(self, mode="cat", channels=None):
        super().__init__()
        if mode not in ("cat", "max", "att"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.score = None
        if mode == "att":
            self.score = lecun_dense(channels, 1)

    def flax_tree(self):
        return {} if self.score is None else {"Dense_0": self.score}

    def forward(self, xs):
        if self.mode == "cat":
            return torch.cat(list(xs), -1)
        if self.mode == "max":
            return torch.stack(list(xs), 0).amax(0)
        h = torch.stack(list(xs), 1)  # (N, L, F)
        att = torch.softmax(dense(self.score, h, None, lecun_normal_)[..., 0],
                            -1)
        return (h * att[..., None]).sum(1)
