"""RGT's cross-manifold structure learners (counterpart of
`gammagl_tpu/layers/attention/rgt.py`; reference:
gammagl/layers/attention/rgt_attention.py:17-205).

The softmax runs per source node over the tiled node space (num_seeds *
N ids, a fixed count), as in JAX; the structure edge buffers are padded
with the id num_seeds * N, which the segment softmax and sum drop and
the gathers clamp. COO, as in JAX: `segment_softmax` and `segment_sum`
in plain PyTorch, no kernel.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv.rgt_layers import ConstCurveLinear, _take
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.ops.segment import segment_sum
from gammagl_tpu_torch.ops.softmax import segment_softmax
from gammagl_tpu_torch.utils.manifold_math import _clip

__all__ = ["CrossManifoldAttention", "EuclideanAttention",
           "HyperbolicStructureLearner", "SphericalStructureLearner",
           "EuclideanStructureLearner"]

_EPS = 1e-8


def _score(scalar_map, q, k, src, dst, num_nodes):
    """Per-edge LeakyReLU(0.2) of a map of [q[src] || k[dst]], softmaxed
    over each source's edges."""
    qk = torch.cat([_take(q, src), _take(k, dst)], -1)
    score = F.leaky_relu(lecun_apply(scalar_map, qk), 0.2)[..., 0]
    return segment_softmax(score, src, num_nodes)


class CrossManifoldAttention(nn.Module):
    """Queries on ``manifold_q`` attend over keys and values on
    ``manifold_k``: the softmaxed scores weight v[dst] into each source,
    the sum is renormalised onto ``manifold_k`` and mapped by ``proj``.
    q_lin, k_lin, v_lin and proj are bias-free `ConstCurveLinear`s with
    ``dropout`` (when not ``deterministic``)."""

    def __init__(self, manifold_q, manifold_k, in_dim, hidden_dim, out_dim,
                 dropout=0.1):
        super().__init__()
        self.manifold_k = manifold_k

        def ccl(m, i, o):
            return ConstCurveLinear(m, i, o, bias=False, dropout=dropout)

        self.q_lin = ccl(manifold_q, in_dim, hidden_dim)
        self.k_lin = ccl(manifold_k, in_dim, hidden_dim)
        self.v_lin = ccl(manifold_k, in_dim, hidden_dim)
        self.scalar_map = lecun_dense(2 * hidden_dim, 1, bias=False)
        self.proj = ccl(manifold_k, hidden_dim, out_dim)

    def flax_tree(self):
        return {"q_lin": self.q_lin, "k_lin": self.k_lin,
                "v_lin": self.v_lin, "scalar_map": self.scalar_map,
                "proj": self.proj}

    def forward(self, x_q, x_k, x_v, edge_index, deterministic=True,
                generator=None):
        q = self.q_lin(x_q, deterministic, generator)
        k = self.k_lin(x_k, deterministic, generator)
        v = self.v_lin(x_v, deterministic, generator)
        src, dst = edge_index[0], edge_index[1]
        num_nodes = q.shape[0]
        score = _score(self.scalar_map, q, k, src, dst, num_nodes)
        out = segment_sum(score[:, None] * _take(v, dst), src, num_nodes)
        m = self.manifold_k
        denorm = torch.sqrt(_clip(m.inner(None, out, keepdim=True).abs(),
                                  _EPS))
        out = out / (math.sqrt(m.k) * denorm)
        return self.proj(out, deterministic, generator)


class EuclideanAttention(nn.Module):
    """The flat-space form: bias-free q_lin, k_lin, v_lin and proj maps,
    dropout on the output (when not ``deterministic``), rows normalised
    by sqrt(|row|^2 + 1e-8)."""

    def __init__(self, in_dim, hidden_dim, out_dim, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.q_lin = lecun_dense(in_dim, hidden_dim, bias=False)
        self.k_lin = lecun_dense(in_dim, hidden_dim, bias=False)
        self.v_lin = lecun_dense(in_dim, hidden_dim, bias=False)
        self.scalar_map = lecun_dense(2 * hidden_dim, 1, bias=False)
        self.proj = lecun_dense(hidden_dim, out_dim, bias=False)

    def flax_tree(self):
        return {"q_lin": self.q_lin, "k_lin": self.k_lin,
                "v_lin": self.v_lin, "scalar_map": self.scalar_map,
                "proj": self.proj}

    def forward(self, x_q, x_k, x_v, edge_index, deterministic=True,
                generator=None):
        q = lecun_apply(self.q_lin, x_q)
        k = lecun_apply(self.k_lin, x_k)
        v = lecun_apply(self.v_lin, x_v)
        src, dst = edge_index[0], edge_index[1]
        num_nodes = q.shape[0]
        score = _score(self.scalar_map, q, k, src, dst, num_nodes)
        out = segment_sum(score[:, None] * _take(v, dst), src, num_nodes)
        out = lecun_apply(self.proj, out)
        if self.dropout > 0.0 and not deterministic:
            out = dropout(out, self.dropout, generator)
        return out / torch.sqrt((out * out).sum(-1, keepdim=True) + _EPS)


def _tiled(n, num_seeds, device):
    return torch.arange(n, device=device).repeat(num_seeds)


def _tiled_structure_agg(manifold, agg_out, x, num_seeds):
    """The Frechet mean of the ``num_seeds`` attended copies of each node
    with the node itself: labels tile(arange(N), S) ++ arange(N)."""
    n = x.shape[0]
    labels = torch.cat([_tiled(n, num_seeds, x.device),
                        torch.arange(n, device=x.device)])
    return manifold.frechet_mean(torch.cat([agg_out, x], 0), labels, n)


class HyperbolicStructureLearner(nn.Module):
    """Attention over BFS trees on the hyperboloid with spherical queries
    (``tree_agg``); ``tree_edge_index`` addresses the tiled (num_seeds *
    N) node space, padded with id num_seeds * N."""

    def __init__(self, manifold_H, manifold_S, in_dim, hidden_dim, out_dim,
                 dropout=0.1):
        super().__init__()
        self.manifold_H = manifold_H
        self.tree_agg = CrossManifoldAttention(manifold_S, manifold_H, in_dim,
                                               hidden_dim, out_dim, dropout)

    def flax_tree(self):
        return {"tree_agg": self.tree_agg}

    def forward(self, x_H, x_S, tree_edge_index, num_seeds,
                deterministic=True, generator=None):
        t = _tiled(x_H.shape[0], num_seeds, x_H.device)
        x = self.tree_agg(x_S[t], x_H[t], x_H[t], tree_edge_index,
                          deterministic, generator)
        return _tiled_structure_agg(self.manifold_H, x, x_H, num_seeds)


class SphericalStructureLearner(nn.Module):
    """Attention over cycles on the sphere with hyperbolic queries
    (``cycle_agg``)."""

    def __init__(self, manifold_H, manifold_S, in_dim, hidden_dim, out_dim,
                 dropout=0.1):
        super().__init__()
        self.manifold_S = manifold_S
        self.cycle_agg = CrossManifoldAttention(manifold_H, manifold_S,
                                                in_dim, hidden_dim, out_dim,
                                                dropout)

    def flax_tree(self):
        return {"cycle_agg": self.cycle_agg}

    def forward(self, x_H, x_S, cycle_edge_index, num_seeds,
                deterministic=True, generator=None):
        t = _tiled(x_S.shape[0], num_seeds, x_S.device)
        x = self.cycle_agg(x_H[t], x_S[t], x_S[t], cycle_edge_index,
                           deterministic, generator)
        return _tiled_structure_agg(self.manifold_S, x, x_S, num_seeds)


class EuclideanStructureLearner(nn.Module):
    """Attention over BFS sequences in flat space (``sequence_agg``)."""

    def __init__(self, manifold_E, in_dim, hidden_dim, out_dim, dropout=0.1):
        super().__init__()
        self.manifold_E = manifold_E
        self.sequence_agg = EuclideanAttention(in_dim, hidden_dim, out_dim,
                                               dropout)

    def flax_tree(self):
        return {"sequence_agg": self.sequence_agg}

    def forward(self, x_E, seq_edge_index, num_seeds, deterministic=True,
                generator=None):
        t = _tiled(x_E.shape[0], num_seeds, x_E.device)
        x = self.sequence_agg(x_E[t], x_E[t], x_E[t], seq_edge_index,
                              deterministic, generator)
        return _tiled_structure_agg(self.manifold_E, x, x_E, num_seeds)
