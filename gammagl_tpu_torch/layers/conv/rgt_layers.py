"""RGT's constant-curvature building blocks (counterpart of
`gammagl_tpu/layers/conv/rgt_layers.py`; reference:
gammagl/layers/conv/rgt_layers.py:454-564).

`ConstCurveLinear` maps a linear output onto a manifold by rescaling its
space part so the (time, space) pair meets the manifold's constraint;
`ConstCurveAgg` sums neighbours (by each edge's source) and renormalises
onto the manifold; `EuclideanEncoder` and `ManifoldEncoder` are RGT's
initial encoders. No plan: the sums are the port's COO segment sum, as
in JAX. The maps are flax default ``Dense``s (lecun-normal kernels, zero
biases), lazy while their in-features are None.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.ops.segment import segment_sum
from gammagl_tpu_torch.utils.manifold_math import LorentzM, _clip

__all__ = ["ConstCurveLinear", "ConstCurveAgg", "EuclideanEncoder",
           "ManifoldEncoder"]

_EPS = 1e-8


def _take(x, idx):
    """x[idx] with the ids clamped into range, as a JAX gather takes
    them (padded structure edges carry an out-of-range id)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)]


class ConstCurveLinear(nn.Module):
    """A linear map (``weight``) whose first output channel becomes the
    time (hyperboloid) or pole (sphere) coordinate and whose other
    channels are scaled so the point lies on ``manifold``; ``scale`` (1,)
    is a log scale of the hyperboloid's time, log(``scale_init``) at
    init. ``activation`` and dropout come first; dropout acts when the
    call is not ``deterministic`` (the JAX flag; the module's training
    mode does not set it) and draws from ``generator``."""

    def __init__(self, manifold, in_features, out_features, bias=True,
                 dropout=0.0, scale_init=10.0, activation=None):
        super().__init__()
        self.manifold = manifold
        self.dropout = dropout
        self.activation = activation
        self.weight = lecun_dense(in_features, out_features, bias=bias)
        self.scale = nn.Parameter(torch.full((1,), math.log(scale_init)))

    def flax_tree(self):
        return {"weight": self.weight, "scale": self.scale}

    def forward(self, x, deterministic=True, generator=None):
        if self.activation is not None:
            x = self.activation(x)
        if self.dropout > 0.0 and not deterministic:
            x = dropout(x, self.dropout, generator)
        x = lecun_apply(self.weight, x)
        space = x[..., 1:]
        if isinstance(self.manifold, LorentzM):
            time = torch.sigmoid(x[..., :1]) * torch.exp(self.scale) + 1.1
            sign = -1.0
        else:
            time = torch.sigmoid(x[..., :1]) - 0.5
            sign = 1.0
        k = self.manifold.k
        sq = _clip((space * space).sum(-1, keepdim=True), _EPS)
        scale = sign * (1.0 / k - time * time) / sq
        return torch.cat([time, space * torch.sqrt(scale)], -1)


class ConstCurveAgg(nn.Module):
    """Neighbourhood sum x[dst] into each edge's source, renormalised onto
    ``manifold``. With ``use_att`` each edge is weighted by
    sigmoid((2 + 2 <query[dst], key[src]>) / ``att_scale`` +
    ``att_bias``), query and key two `ConstCurveLinear` maps."""

    def __init__(self, manifold, in_features, dropout=0.0, use_att=False):
        super().__init__()
        self.manifold = manifold
        self.use_att = use_att
        if use_att:
            self.query = ConstCurveLinear(manifold, in_features, in_features)
            self.key = ConstCurveLinear(manifold, in_features, in_features)
            self.att_bias = nn.Parameter(torch.full((1,), 20.0))
            self.att_scale = nn.Parameter(torch.full((1,),
                                                     in_features ** 0.5))

    def flax_tree(self):
        if not self.use_att:
            return {}
        return {"query": self.query, "key": self.key,
                "att_bias": self.att_bias, "att_scale": self.att_scale}

    def forward(self, x, edge_index):
        src, dst = edge_index[0], edge_index[1]
        num_nodes = x.shape[0]
        sign = -1.0 if isinstance(self.manifold, LorentzM) else 1.0
        if self.use_att:
            query, key = self.query(x), self.key(x)
            att = 2.0 + 2.0 * self.manifold.cinner(_take(query, dst),
                                                   _take(key, src))
            att = torch.sigmoid(att / self.att_scale + self.att_bias)
            support = segment_sum(att * _take(x, dst), src, num_nodes)
        else:
            support = segment_sum(_take(x, dst), src, num_nodes)
        denorm = torch.sqrt(_clip(
            (sign * self.manifold.inner(None, support, keepdim=True)).abs(),
            _EPS))
        return support / (math.sqrt(self.manifold.k) * denorm)


class EuclideanEncoder(nn.Module):
    """``lin`` (to ``hidden_dim``), the activation, dropout (when not
    ``deterministic``), ``proj`` (to ``out_dim``), then each row over
    sqrt(|row|^2 + 1e-8)."""

    def __init__(self, in_dim, hidden_dim, out_dim, bias=True,
                 activation=F.relu, dropout=0.1):
        super().__init__()
        self.activation = activation
        self.dropout = dropout
        self.lin = lecun_dense(in_dim, hidden_dim, bias=bias)
        self.proj = lecun_dense(hidden_dim, out_dim, bias=bias)

    def flax_tree(self):
        return {"lin": self.lin, "proj": self.proj}

    def forward(self, x, deterministic=True, generator=None):
        x = lecun_apply(self.lin, x)
        if self.activation is not None:
            x = self.activation(x)
        if self.dropout > 0.0 and not deterministic:
            x = dropout(x, self.dropout, generator)
        x = lecun_apply(self.proj, x)
        return x / torch.sqrt((x * x).sum(-1, keepdim=True) + _EPS)


class ManifoldEncoder(nn.Module):
    """``manifold.expmap0``, a `ConstCurveLinear` (``lin``), then a
    `ConstCurveAgg` (``agg``) over ``edge_index``."""

    def __init__(self, manifold, in_dim, hidden_dim, out_dim, bias=True,
                 activation=None, dropout=0.0):
        super().__init__()
        self.manifold = manifold
        self.lin = ConstCurveLinear(manifold, in_dim, out_dim, bias=bias,
                                    dropout=dropout, activation=activation)
        self.agg = ConstCurveAgg(manifold, out_dim)

    def flax_tree(self):
        return {"lin": self.lin, "agg": self.agg}

    def forward(self, x, edge_index, deterministic=True, generator=None):
        x = self.manifold.expmap0(x)
        return self.agg(self.lin(x, deterministic, generator), edge_index)
