"""The wave-2 convs: PNA, FiLM, EdgeConv, GMM, CompGCN, GaAN, DNA and
Hypergraph (HCHA) convolutions (counterparts of
`gammagl_tpu/layers/conv/wave2_convs.py`).

Like the JAX layers they take no plan: every conv gathers its per-edge
rows and reduces them with the port's COO ops (`ops/segment.py`,
`ops/softmax.py`, `ops/spmm.py`), which the JAX layers run as XLA
``segment_*`` ops. Gathers clamp their index to the table, as JAX's
``mode="clip"`` does, and an out-of-range destination drops its message,
so padded edges are no-ops. Counts (degrees, hyperedge sizes) are taken
in float32 and cast to x's dtype; the JAX layers count in x's dtype,
which saturates at 256 in bfloat16 (ROADMAP C21). Each conv names its
flax parameters in ``flax_tree`` (`utils.load_jax_params`);
``in_channels=None`` leaves the first map lazy, as flax infers it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.ops.segment import (segment_count, segment_max,
                                           segment_mean, segment_min,
                                           segment_sum)
from gammagl_tpu_torch.ops.softmax import segment_softmax
from gammagl_tpu_torch.ops.spmm import bspmm

__all__ = ["PNAConv", "FILMConv", "EdgeConv", "GMMConv", "CompConv",
           "GaANConv", "DNAConv", "HypergraphConv"]


def _take(x, index):
    """x[index] with the index clamped into x's rows (JAX's
    ``jnp.take(..., mode="clip")``)."""
    return x[index.long().clamp(0, x.shape[0] - 1)]


def _count(index, num_segments, dtype):
    """Entries per segment, counted in float32 and cast to ``dtype``."""
    return segment_count(index, num_segments).to(dtype)


def _width(in_channels, times, plus=0):
    return None if in_channels is None else in_channels * times + plus


class PNAConv(MessagePassing):
    """Principal neighbourhood aggregation (Corso et al. 2020): the
    ``aggregators`` of each destination's gathered sources ('mean',
    'max', 'min', 'std' = sqrt(max(E[x^2] - E[x]^2, 0) + 1e-5), 'sum'),
    each scaled by the ``scalers`` ('identity', 'amplification' =
    log(deg + 1) / avg_deg_log, 'attenuation' = avg_deg_log /
    max(log(deg + 1), 1e-5)), then one map (flax ``Dense_0``, with bias)
    of [x || scaled aggregates]. ``avg_deg_log`` is a constant (default
    1.0), not computed from the data."""

    def __init__(self, in_channels, out_channels,
                 aggregators=("mean", "max", "min", "std"),
                 scalers=("identity", "amplification", "attenuation"),
                 avg_deg_log=1.0):
        super().__init__()
        for a in aggregators:
            if a not in ("mean", "max", "min", "std", "sum"):
                raise ValueError(a)
        for s in scalers:
            if s not in ("identity", "amplification", "attenuation"):
                raise ValueError(s)
        self.aggregators, self.scalers = tuple(aggregators), tuple(scalers)
        self.avg_deg_log = avg_deg_log
        self.lin = lecun_dense(
            _width(in_channels, 1 + len(aggregators) * len(scalers)),
            out_channels)

    def flax_tree(self):
        return {"Dense_0": self.lin}

    def forward(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        dst = edge_index[1]
        msg = _take(x, edge_index[0])
        mean = segment_mean(msg, dst, num_nodes)
        outs = []
        for a in self.aggregators:
            if a == "mean":
                outs.append(mean)
            elif a == "max":
                outs.append(segment_max(msg, dst, num_nodes))
            elif a == "min":
                outs.append(segment_min(msg, dst, num_nodes))
            elif a == "std":
                sq = segment_mean(msg ** 2, dst, num_nodes)
                outs.append(torch.sqrt((sq - mean ** 2).clamp_min(0)
                                       + 1e-5))
            else:
                outs.append(segment_sum(msg, dst, num_nodes))
        h = torch.cat(outs, dim=-1)
        logd = torch.log(segment_count(dst, num_nodes) + 1)[:, None]
        scaled = []
        for s in self.scalers:
            if s == "identity":
                scaled.append(h)
            elif s == "amplification":
                scaled.append(h * (logd / self.avg_deg_log).to(h.dtype))
            else:
                scaled.append(h * (self.avg_deg_log
                                   / logd.clamp_min(1e-5)).to(h.dtype))
        h = torch.cat(scaled, dim=-1)
        return lecun_apply(self.lin, torch.cat([x[:num_nodes], h], dim=-1))


class FILMConv(MessagePassing):
    """GNN-FiLM (Brockschmidt 2020): a self term relu(g * W0 x + b) with
    [g || b] = W1 x (flax ``Dense_0`` without bias, ``Dense_1``), plus,
    for each relation r, the mean over each destination's edges of
    relu(gamma_d * W x_s + beta_d), [gamma || beta] = W' x at the
    destination (``Dense_{2+2r}`` without bias, ``Dense_{3+2r}``). With
    ``edge_type`` and more than one relation, edges of other types add
    zeros to relation r's mean (they still count in its divisor, as in
    the JAX layer)."""

    def __init__(self, in_channels, out_channels, num_relations=1,
                 act="relu"):
        super().__init__()
        self.out_channels, self.num_relations = out_channels, num_relations
        self.lin_self = lecun_dense(in_channels, out_channels, bias=False)
        self.film_self = lecun_dense(in_channels, 2 * out_channels)
        self.lins = nn.ModuleList(
            lecun_dense(in_channels, out_channels, bias=False)
            for _ in range(num_relations))
        self.films = nn.ModuleList(
            lecun_dense(in_channels, 2 * out_channels)
            for _ in range(num_relations))

    def flax_tree(self):
        tree = {"Dense_0": self.lin_self, "Dense_1": self.film_self}
        for r in range(self.num_relations):
            tree[f"Dense_{2 + 2 * r}"] = self.lins[r]
            tree[f"Dense_{3 + 2 * r}"] = self.films[r]
        return tree

    def forward(self, x, edge_index, edge_type=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        xn = x[:num_nodes]
        g, b = lecun_apply(self.film_self, xn).chunk(2, dim=-1)
        out = F.relu(g * lecun_apply(self.lin_self, xn) + b)
        for r in range(self.num_relations):
            h = lecun_apply(self.lins[r], x)
            gamma, beta = lecun_apply(self.films[r], x).chunk(2, dim=-1)
            msg = F.relu(_take(gamma, dst) * _take(h, src)
                         + _take(beta, dst))
            if edge_type is not None and self.num_relations > 1:
                msg = msg * (edge_type == r)[:, None].to(msg.dtype)
            out = out + segment_mean(msg, dst, num_nodes)
        return out


class EdgeConv(MessagePassing):
    """EdgeConv (Wang et al. 2019): max over each destination's edges of
    MLP([x_d || x_s - x_d]), the MLP a map, ReLU and a map (flax
    ``Dense_0``, ``Dense_1``, both with bias)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.lin1 = lecun_dense(_width(in_channels, 2), out_channels)
        self.lin2 = lecun_dense(out_channels, out_channels)

    def flax_tree(self):
        return {"Dense_0": self.lin1, "Dense_1": self.lin2}

    def forward(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        x_j = _take(x, edge_index[0])
        x_i = _take(x, edge_index[1])
        msg = lecun_apply(self.lin2, F.relu(lecun_apply(
            self.lin1, torch.cat([x_i, x_j - x_i], dim=-1))))
        return segment_max(msg, edge_index[1], num_nodes)


class GMMConv(MessagePassing):
    """Gaussian mixture conv, MoNet (Monti et al. 2017): each edge's
    pseudo-coordinates p weigh ``kernel_size`` maps of the source,
    w_k = exp(-0.5 sum_j ((p_j - mu_kj) / (sigma_kj + 1e-8))^2); the
    messages are summed over k, then over each destination's edges.
    Parameters: the bias-free map to K x out (flax ``Dense_0``), ``mu``
    (K, dim), drawn normal with std 0.1, and ``sigma`` (K, dim), ones."""

    def __init__(self, in_channels, out_channels, dim=2, kernel_size=3):
        super().__init__()
        self.out_channels, self.kernel_size = out_channels, kernel_size
        self.lin = lecun_dense(in_channels, kernel_size * out_channels,
                               bias=False)
        self.mu = nn.Parameter(torch.randn(kernel_size, dim) * 0.1)
        self.sigma = nn.Parameter(torch.ones(kernel_size, dim))

    def flax_tree(self):
        return {"Dense_0": self.lin, "mu": self.mu, "sigma": self.sigma}

    def forward(self, x, edge_index, pseudo, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        diff = pseudo[:, None, :] - self.mu[None]
        w = torch.exp(-0.5 * ((diff / (self.sigma[None] + 1e-8)) ** 2)
                      .sum(-1))
        h = lecun_apply(self.lin, x).reshape(-1, self.kernel_size,
                                             self.out_channels)
        msg = _take(h, edge_index[0]) * w[..., None]
        return segment_sum(msg.sum(1), edge_index[1], num_nodes)


class CompConv(MessagePassing):
    """CompGCN conv (Vashishth et al. 2020): messages W (x_s - r_e)
    ('sub') or W (x_s * r_e) ('mult') from the relation embeddings
    ``rel_emb`` (R, F) of each edge's type, their mean per destination
    plus W_self x (flax ``Dense_0``, ``Dense_1``, no bias). Returns (out,
    rel_emb mapped by its own bias-free ``Dense_2``) so the caller can
    thread the relations through its layers."""

    def __init__(self, in_channels, out_channels, op="sub"):
        super().__init__()
        if op not in ("sub", "mult"):
            raise ValueError(op)
        self.op = op
        self.lin_msg = lecun_dense(in_channels, out_channels, bias=False)
        self.lin_self = lecun_dense(in_channels, out_channels, bias=False)
        self.lin_rel = lecun_dense(in_channels, out_channels, bias=False)

    def flax_tree(self):
        return {"Dense_0": self.lin_msg, "Dense_1": self.lin_self,
                "Dense_2": self.lin_rel}

    def forward(self, x, edge_index, edge_type, rel_emb, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        # an embedding lookup, not an index: the backward of an indexed
        # gather of 5M rows from 3 relations (an accumulating index_put_)
        # held CompGCN's step on the card at ~2.9 s; an embedding's
        # backward sums the rows into their relations by a sort and
        # partial sums
        r = F.embedding(edge_type.long(), rel_emb)
        h = _take(x, edge_index[0])
        comp = h - r if self.op == "sub" else h * r
        out = segment_mean(lecun_apply(self.lin_msg, comp), edge_index[1],
                           num_nodes)
        out = out + lecun_apply(self.lin_self, x[:num_nodes])
        return out, lecun_apply(self.lin_rel, rel_emb)


class GaANConv(MessagePassing):
    """Gated attention (Zhang et al. 2018): ``heads`` GAT heads over the
    bias-free map h = W x (flax ``Dense_0``, H x out), scored
    leaky_relu(att . [h_s || h_d], 0.2) (``att`` (1, H, 2 out)) and
    softmaxed over each destination's edges; each head's sum gated by a
    sigmoid of ``Dense_1`` [x || max_s x_s || mean_s x_s]; then ``Dense_2``
    of [x || the gated heads]."""

    def __init__(self, in_channels, out_channels, heads=4):
        super().__init__()
        self.out_channels, self.heads = out_channels, heads
        self.lin = lecun_dense(in_channels, heads * out_channels,
                               bias=False)
        # flax's truncated_normal(0.02): a unit normal cut at +-2, times
        # 0.02
        self.att = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, heads, 2 * out_channels), 0.0, 1.0, -2.0, 2.0)
            .mul_(0.02))
        self.gate = lecun_dense(_width(in_channels, 3), heads)
        self.out = lecun_dense(_width(in_channels, 1, heads * out_channels),
                               out_channels)

    def flax_tree(self):
        return {"Dense_0": self.lin, "Dense_1": self.gate,
                "Dense_2": self.out, "att": self.att}

    def forward(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        H, C = self.heads, self.out_channels
        src, dst = edge_index[0], edge_index[1]
        h = lecun_apply(self.lin, x).reshape(-1, H, C)
        feat = torch.cat([_take(h, src), _take(h, dst)], dim=-1)
        e = F.leaky_relu((feat * self.att).sum(-1), 0.2)
        alpha = segment_softmax(e, dst, num_nodes)
        agg = bspmm(edge_index, alpha, h, num_nodes=num_nodes)
        msg = _take(x, src)
        gate = lecun_apply(self.gate, torch.cat(
            [x[:num_nodes], segment_max(msg, dst, num_nodes),
             segment_mean(msg, dst, num_nodes)], dim=-1))
        out = (agg * torch.sigmoid(gate)[..., None]).reshape(-1, H * C)
        return lecun_apply(self.out, torch.cat([x[:num_nodes], out], dim=-1))


class DNAConv(MessagePassing):
    """Dynamic neighbourhood aggregation (Fey 2019): the query of each
    destination's last representation attends, per head and per edge,
    over the L stacked representations of the source (keys and values);
    the attended values are averaged over each destination's edges.
    ``x_all`` is (N, L, F) with F divisible by ``heads``; the query, key
    and value maps are bias-free (flax ``Dense_0``, ``Dense_1``,
    ``Dense_2``), F -> F."""

    def __init__(self, channels=None, heads=1):
        super().__init__()
        self.heads = heads
        self.lin_q = lecun_dense(channels, channels or 0, bias=False)
        self.lin_k = lecun_dense(channels, channels or 0, bias=False)
        self.lin_v = lecun_dense(channels, channels or 0, bias=False)

    def flax_tree(self):
        return {"Dense_0": self.lin_q, "Dense_1": self.lin_k,
                "Dense_2": self.lin_v}

    def forward(self, x_all, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x_all.shape[0]
        _, L, Fdim = x_all.shape
        H = self.heads
        D = Fdim // H
        src, dst = edge_index[0], edge_index[1]
        q = lecun_apply(self.lin_q, x_all[:, -1])
        k = lecun_apply(self.lin_k, x_all)
        v = lecun_apply(self.lin_v, x_all)
        q_e = _take(q, dst).reshape(-1, H, 1, D)
        k_e = _take(k, src).reshape(-1, L, H, D).transpose(1, 2)
        v_e = _take(v, src).reshape(-1, L, H, D).transpose(1, 2)
        attn = torch.softmax((q_e * k_e).sum(-1) / (D ** 0.5), dim=-1)
        msg = (attn[..., None] * v_e).sum(2)
        return segment_mean(msg.reshape(-1, Fdim), dst, num_nodes)


class HypergraphConv(MessagePassing):
    """Hypergraph conv (Bai et al. 2021): X' = D^-1 H W B^-1 H^T (X Theta)
    on the (node, hyperedge) incidence pairs ``hyperedge_index`` (2, nnz):
    each hyperedge takes the mean of its members' rows, scaled by its
    weight (default 1), and each node the mean of its hyperedges'.
    Theta is bias-free (flax ``Dense_0``). ``use_attention`` and
    ``heads`` are accepted and ignored, as in the JAX layer (ROADMAP
    C22). ``num_edges`` defaults to max(hyperedge id) + 1, one read of
    the ids to the host."""

    def __init__(self, in_channels, out_channels, use_attention=False,
                 heads=1):
        super().__init__()
        self.use_attention, self.heads = use_attention, heads
        self.lin = lecun_dense(in_channels, out_channels, bias=False)

    def flax_tree(self):
        return {"Dense_0": self.lin}

    def forward(self, x, hyperedge_index, hyperedge_weight=None,
                num_nodes=None, num_edges=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        node, he = hyperedge_index[0], hyperedge_index[1]
        if num_edges is None:
            num_edges = int(he.max()) + 1
        h = lecun_apply(self.lin, x)
        w = (hyperedge_weight if hyperedge_weight is not None
             else torch.ones(num_edges, dtype=x.dtype, device=x.device))
        d_e = _count(he, num_edges, x.dtype)
        edge_feat = segment_sum(_take(h, node), he, num_edges)
        edge_feat = edge_feat / d_e.clamp_min(1)[:, None]
        edge_feat = edge_feat * w[:, None]
        d_v = _count(node, num_nodes, x.dtype)
        out = segment_sum(_take(edge_feat, he), node, num_nodes)
        return out / d_v.clamp_min(1)[:, None]
