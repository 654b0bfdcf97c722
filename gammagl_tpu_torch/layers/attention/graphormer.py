"""Graphormer's dense attention with structural encodings (counterpart of
`gammagl_tpu/layers/attention/graphormer.py`; reference:
gammagl/layers/attention/{graphormer_layer,centrality_encoder,
spatial_encoder,edge_encoder}.py).

Each graph attends densely over its own nodes: a softmax over an (H, N,
N) score tensor, plain PyTorch products. flax's conventions are kept:
``nn.Embed`` tables (an ``nn.Embedding``, normal with variance 1 / width
at init), ``LayerNorm`` with epsilon 1e-6 and the tanh GELU.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense

__all__ = ["CentralityEncoder", "SpatialEncoder", "EdgeEncoder",
           "GraphormerLayer"]


def flax_embed(num_embeddings, features):
    """flax's ``nn.Embed``: a table whose rows are normal with variance
    1 / ``features`` at init."""
    emb = nn.Embedding(num_embeddings, features)
    with torch.no_grad():
        emb.weight.normal_(0.0, 1.0 / math.sqrt(features))
    return emb


class CentralityEncoder(nn.Module):
    """x plus learned embeddings of each node's in- and out-degree, the
    degrees clipped to [0, ``max_degree``] (``Embed_0``, ``Embed_1``)."""

    def __init__(self, max_degree, embedding_dim):
        super().__init__()
        self.max_degree = max_degree
        self.z_in = flax_embed(max_degree + 1, embedding_dim)
        self.z_out = flax_embed(max_degree + 1, embedding_dim)

    def flax_tree(self):
        return {"Embed_0": self.z_in, "Embed_1": self.z_out}

    def forward(self, x, in_degree, out_degree):
        def clip(d):
            return d.long().clamp(0, self.max_degree)
        return x + self.z_in(clip(in_degree)) + self.z_out(clip(out_degree))


class SpatialEncoder(nn.Module):
    """A per-head attention bias from each pair's shortest-path distance:
    (N, N) ids -> (N, N, H); distances clip to [0, ``max_dist``] and -1
    (unreachable, or padding) takes row ``max_dist + 1`` (``Embed_0``)."""

    def __init__(self, max_dist, num_heads):
        super().__init__()
        self.max_dist = max_dist
        self.table = flax_embed(max_dist + 2, num_heads)

    def flax_tree(self):
        return {"Embed_0": self.table}

    def forward(self, dist):
        dist = dist.long()
        d = torch.where(dist < 0, self.max_dist + 1,
                        dist.clamp(0, self.max_dist))
        return self.table(d)


class EdgeEncoder(nn.Module):
    """The direct-edge form of Graphormer's edge encoding: a bias-free map
    of dense (N, N, F) edge features to H heads (``Dense_0``)."""

    def __init__(self, num_heads, in_features=None):
        super().__init__()
        self.lin = lecun_dense(in_features, num_heads, bias=False)

    def flax_tree(self):
        return {"Dense_0": self.lin}

    def forward(self, edge_attr_dense):
        return lecun_apply(self.lin, edge_attr_dense)


class GraphormerLayer(nn.Module):
    """Pre-LN multi-head self-attention and a feed-forward block, each
    residual. ``attn_bias`` (N, N, H) adds to the scores; ``mask`` (N,)
    hides padded keys (score -1e9). Dropout (on the attention, the two
    residual branches and the hidden FFN layer) acts in training mode and
    draws from ``generator``. flax names: ``LayerNorm_0``, the bias-free
    ``Dense_0`` / ``Dense_1`` / ``Dense_2`` (q, k, v), ``Dense_3`` (the
    output map), ``LayerNorm_1``, ``Dense_4`` / ``Dense_5`` (the FFN)."""

    def __init__(self, hidden_dim, num_heads, ffn_dim=None,
                 dropout_rate=0.1):
        super().__init__()
        H = num_heads
        D = hidden_dim // H
        ffn_dim = ffn_dim or 4 * hidden_dim
        self.num_heads, self.head_dim = H, D
        self.dropout_rate = dropout_rate
        self.norm0 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.q = lecun_dense(hidden_dim, H * D, bias=False)
        self.k = lecun_dense(hidden_dim, H * D, bias=False)
        self.v = lecun_dense(hidden_dim, H * D, bias=False)
        self.out = lecun_dense(H * D, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.ffn_in = lecun_dense(hidden_dim, ffn_dim)
        self.ffn_out = lecun_dense(ffn_dim, hidden_dim)

    def flax_tree(self):
        return {"LayerNorm_0": self.norm0, "Dense_0": self.q,
                "Dense_1": self.k, "Dense_2": self.v, "Dense_3": self.out,
                "LayerNorm_1": self.norm1, "Dense_4": self.ffn_in,
                "Dense_5": self.ffn_out}

    def forward(self, x, attn_bias=None, mask=None, generator=None):
        H, D = self.num_heads, self.head_dim
        rate = self.dropout_rate if self.training else 0.0

        def drop(t):
            return dropout(t, rate, generator)

        h = self.norm0(x)
        q = lecun_apply(self.q, h).reshape(-1, H, D)
        k = lecun_apply(self.k, h).reshape(-1, H, D)
        v = lecun_apply(self.v, h).reshape(-1, H, D)
        scores = torch.einsum("nhd,mhd->hnm", q, k) / (D ** 0.5)
        if attn_bias is not None:
            scores = scores + attn_bias.permute(2, 0, 1)
        if mask is not None:
            scores = torch.where(mask[None, None, :], scores,
                                 torch.full((), -1e9, dtype=scores.dtype,
                                            device=scores.device))
        attn = drop(torch.softmax(scores, dim=-1))
        out = torch.einsum("hnm,mhd->nhd", attn, v).reshape(-1, H * D)
        x = x + drop(lecun_apply(self.out, out))
        h = self.norm1(x)
        h = drop(F.gelu(lecun_apply(self.ffn_in, h), approximate="tanh"))
        return x + drop(lecun_apply(self.ffn_out, h))
