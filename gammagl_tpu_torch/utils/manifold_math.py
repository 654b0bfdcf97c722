"""Hyperbolic and spherical manifold operations for the RGT family
(counterpart of `gammagl_tpu/utils/manifold_math.py`; reference:
gammagl/utils/manifold_math.py and gammagl/layers/conv/rgt_layers.py).

The Poincare-ball functions (exp / log maps, Mobius addition, distances)
and four manifold objects: `EuclideanM`, `SphereM`, `LorentzM` and their
`ProductM`. Every clamp and epsilon is the JAX module's. A clamp is taken
as JAX takes ``jnp.clip`` and ``jnp.maximum``: a maximum, then a minimum,
so an input exactly on a bound passes half of its gradient, as in JAX
(``torch.clamp`` would pass all of it; ROADMAP C34). The norms that JAX
takes with ``jnp.linalg.norm`` are ``torch.linalg.vector_norm``, whose
gradient at a zero vector is 0 where JAX's is NaN (C35).
"""

import math

import torch

from gammagl_tpu_torch.ops.segment import segment_mean, segment_sum

__all__ = ["mobius_add", "expmap", "logmap", "expmap0", "logmap0",
           "poincare_distance", "project", "EuclideanM", "SphereM",
           "LorentzM", "ProductM"]

_EPS = 1e-7


def _clip(x, lo=None, hi=None):
    """``jnp.clip(x, lo, hi)``: max with ``lo``, then min with ``hi``; a
    tie with a bound splits the gradient in halves, as in JAX."""
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _sqrt(c):
    return torch.sqrt(c) if isinstance(c, torch.Tensor) else math.sqrt(c)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _lambda_x(x, c):
    return 2.0 / _clip(1 - c * (x * x).sum(-1, keepdim=True), _EPS)


def project(x, c, eps=1e-5):
    """Clip to the open Poincare ball of curvature -c."""
    norm = _clip(_norm(x), _EPS)
    max_norm = (1 - eps) / _sqrt(c)
    return torch.where(norm > max_norm, x / norm * max_norm, x)


def mobius_add(x, y, c):
    """Mobius addition on the Poincare ball."""
    xy = (x * y).sum(-1, keepdim=True)
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    den = 1 + 2 * c * xy + c * c * x2 * y2
    return num / _clip(den, _EPS)


def expmap(v, x, c):
    """Exponential map of tangent vector v at point x."""
    v_norm = _clip(_norm(v), _EPS)
    sc = _sqrt(c)
    second = torch.tanh(sc * _lambda_x(x, c) * v_norm / 2) * v / (sc * v_norm)
    return project(mobius_add(x, second, c), c)


def logmap(y, x, c):
    """Logarithm map of y at base point x."""
    sub = mobius_add(-x, y, c)
    sub_norm = _clip(_norm(sub), _EPS)
    sc = _sqrt(c)
    return (2 / (sc * _lambda_x(x, c)) * torch.atanh(
        _clip(sc * sub_norm, 0, 1 - _EPS)) * sub / sub_norm)


def expmap0(v, c):
    """Exp map at the origin."""
    v_norm = _clip(_norm(v), _EPS)
    sc = _sqrt(c)
    return project(torch.tanh(sc * v_norm) * v / (sc * v_norm), c)


def logmap0(y, c):
    """Log map at the origin."""
    y_norm = _clip(_norm(y), _EPS)
    sc = _sqrt(c)
    return torch.atanh(_clip(sc * y_norm, 0, 1 - _EPS)) * y / (sc * y_norm)


def poincare_distance(x, y, c):
    """Geodesic distance on the Poincare ball."""
    sc = _sqrt(c)
    add = mobius_add(-x, y, c)
    return 2 / sc * torch.atanh(_clip(
        sc * torch.linalg.vector_norm(add, dim=-1), 0, 1 - _EPS))


def _safe_norm(x, eps=1e-12):
    """sqrt(sum(x^2) + eps) on the last axis, kept: an L2 norm whose
    gradient is finite at x = 0."""
    return torch.sqrt((x * x).sum(-1, keepdim=True) + eps)


def _origin(x, value):
    """Zeros like ``x`` with ``value`` on the first coordinate."""
    o = torch.zeros_like(x)
    o[..., 0] = value
    return o


# The constant-curvature manifolds of the RGT family (reference
# rgt_layers.py:40-452 wraps geoopt's): value objects compared by type and
# curvature, whose methods are plain tensor functions.


class _Manifold:
    """Base: equal by (type, curvature)."""

    k = 1.0

    def __eq__(self, other):
        return type(self) is type(other) and self.k == other.k

    def __hash__(self):
        return hash((type(self).__name__, self.k))

    def _renorm(self, z, eps=1e-8):
        """z / (sqrt(k) * sqrt(max(|<z, z>|, eps))): an ambient vector
        back onto the manifold, as the reference's Frechet mean does."""
        denorm = torch.sqrt(_clip(self.inner(None, z, keepdim=True).abs(),
                                  eps))
        return z / (math.sqrt(self.k) * denorm)

    def frechet_mean(self, x, sum_idx, num_segments, weights=None):
        """Segment sum of ``x`` (times ``weights``) by ``sum_idx`` into
        ``num_segments`` rows, renormalised onto the manifold."""
        if weights is not None:
            x = x * weights
        return self._renorm(segment_sum(x, sum_idx, num_segments))


class EuclideanM(_Manifold):
    """Flat manifold: exp and log maps are the identity, the Frechet mean
    the segment mean."""

    name = "euclidean"

    def expmap0(self, v):
        return v

    def logmap0(self, v):
        return v

    def proju(self, x, u):
        return u

    def proju0(self, v):
        return v

    def projx(self, x):
        return x

    def transp0back(self, x, u):
        return u

    def inner(self, x, u, v=None, keepdim=False):
        v = u if v is None else v
        return (u * v).sum(-1, keepdim=keepdim)

    def cinner(self, x, y):
        if x.shape == y.shape:
            return (x * y).sum(-1, keepdim=True)
        return x @ y.transpose(-1, -2)

    def norm(self, u, x=None, keepdim=False):
        n = _safe_norm(u)
        return n if keepdim else n[..., 0]

    def dist(self, x, y, keepdim=False):
        n = _safe_norm(x - y)
        return n if keepdim else n[..., 0]

    def frechet_mean(self, x, sum_idx, num_segments, weights=None):
        if weights is not None:
            x = x * weights
        return segment_mean(x, sum_idx, num_segments)


class SphereM(_Manifold):
    """Unit hypersphere, pole at -e0."""

    name = "sphere"

    def origin_like(self, x):
        return _origin(x, -1.0)

    def proju(self, x, u):
        return u - (x * u).sum(-1, keepdim=True) * x

    def proju0(self, u):
        return self.proju(self.origin_like(u), u)

    def projx(self, x):
        return x / _safe_norm(x, eps=_EPS * _EPS)

    def inner(self, x, u, v=None, keepdim=False):
        v = u if v is None else v
        return (u * v).sum(-1, keepdim=keepdim)

    def cinner(self, x, y):
        if x.shape == y.shape:
            return (x * y).sum(-1, keepdim=True)
        return x @ y.transpose(-1, -2)

    def norm(self, u, x=None, keepdim=False):
        n = _safe_norm(u)
        return n if keepdim else n[..., 0]

    def expmap(self, x, u):
        # the safe norm makes sin(nu)/nu smooth at u = 0
        nu = _safe_norm(u)
        return x * torch.cos(nu) + u * torch.sin(nu) / nu

    def expmap0(self, u):
        return self.expmap(self.origin_like(u), u)

    def logmap(self, x, y):
        u = self.proju(x, y - x)
        d = self.dist(x, y, keepdim=True)
        nu = _safe_norm(u, eps=_EPS * _EPS)
        return u * d / nu

    def logmap0(self, y):
        return self.logmap(self.origin_like(y), y)

    def dist(self, x, y, keepdim=False):
        cos = _clip((x * y).sum(-1, keepdim=keepdim) / self.k,
                    -1.0 + 1e-6, 1.0 - 1e-6)
        return math.sqrt(self.k) * torch.arccos(cos)

    def pairwise_dist(self, x, codes):
        """(..., N, d) x (..., C, d) -> (..., N, C) geodesic distances:
        one (batched) product and an arccos."""
        cos = _clip((x @ codes.transpose(-1, -2)) / self.k, -1.0 + 1e-6,
                    1.0 - 1e-6)
        return math.sqrt(self.k) * torch.arccos(cos)

    def transp(self, x, y, u):
        return self.proju(y, self.proju(x, u))

    def transp0back(self, x, u):
        return self.transp(x, self.origin_like(x), u)


def _flip(x):
    """x with its time coordinate negated."""
    return torch.cat([-x[..., :1], x[..., 1:]], -1)


class LorentzM(_Manifold):
    """Hyperboloid model, time axis first: <x, y>_L = -x0 y0 + <xs, ys>;
    points satisfy <x, x>_L = -k."""

    name = "lorentz"

    def origin_like(self, x):
        return _origin(x, math.sqrt(self.k))

    def inner(self, x, u, v=None, keepdim=False):
        v = u if v is None else v
        return (_flip(u) * v).sum(-1, keepdim=keepdim)

    def cinner(self, x, y):
        if x.shape == y.shape:
            return ((x[..., 1:] * y[..., 1:]).sum(-1, keepdim=True)
                    - x[..., :1] * y[..., :1])
        return _flip(x) @ y.transpose(-1, -2)

    def norm(self, u, x=None, keepdim=False):
        return torch.sqrt(_clip(self.inner(None, u, keepdim=keepdim), 1e-8))

    def proju(self, x, u):
        # tangent projection: u + <x, u>_L / k * x
        return u + self.inner(x, x, u, keepdim=True) / self.k * x

    def proju0(self, v):
        return self.proju(self.origin_like(v), v)

    def projx(self, x):
        sp = (x[..., 1:] ** 2).sum(-1, keepdim=True)
        return torch.cat([torch.sqrt(self.k + sp), x[..., 1:]], -1)

    def expmap(self, x, u):
        sk = math.sqrt(self.k)
        n = self.norm(u, keepdim=True)
        safe = _clip(n / sk, _EPS)
        return torch.cosh(n / sk) * x + torch.sinh(safe) / safe * u

    def expmap0(self, u):
        return self.expmap(self.origin_like(u), u)

    def logmap0(self, x):
        sk = math.sqrt(self.k)
        y = x[..., 1:]
        yn = _safe_norm(y, eps=1e-12)
        theta = _clip(x[..., :1] / sk, 1.0 + 1e-7)
        r = sk * torch.arccosh(theta) * y / yn
        return torch.cat([torch.zeros_like(r[..., :1]), r], -1)

    def dist(self, x, y, keepdim=False):
        arg = _clip(-self.cinner(x, y) / self.k, 1.0 + 1e-5)
        d = math.sqrt(self.k) * torch.arccosh(arg)
        return d if keepdim or d.shape[-1] != 1 else d[..., 0]

    def pairwise_dist(self, x, codes):
        """(..., N, d) x (..., C, d) -> (..., N, C): the Lorentz inner
        products are one (batched) product."""
        arg = _clip(-(_flip(x) @ codes.transpose(-1, -2)) / self.k,
                    1.0 + 1e-5)
        return math.sqrt(self.k) * torch.arccosh(arg)

    def transp0back(self, x, u):
        # reflection through the tangent component of x at the origin
        o = self.origin_like(x)
        xo = self.proju(o, x)
        num = self.inner(o, xo, u, keepdim=True)
        den = self.inner(o, xo, xo, keepdim=True) + 1e-8
        return u - 2.0 * num / den * xo


class ProductM:
    """Product of (manifold, dim) factors: logmap0, proju0, expmap0 and
    the Frechet mean apply factor by factor over feature slices."""

    def __init__(self, *factors):
        self.factors = tuple(factors)  # ((manifold, dim), ...)

    def __eq__(self, other):
        return isinstance(other, ProductM) and self.factors == other.factors

    def __hash__(self):
        return hash(self.factors)

    def _split(self, x):
        out, off = [], 0
        for m, d in self.factors:
            out.append((m, x[..., off:off + d]))
            off += d
        return out

    def logmap0(self, x):
        return torch.cat([m.logmap0(p) for m, p in self._split(x)], -1)

    def proju0(self, v):
        return torch.cat([m.proju0(p) for m, p in self._split(v)], -1)

    def expmap0(self, v):
        return torch.cat([m.expmap0(p) for m, p in self._split(v)], -1)

    def frechet_mean(self, x, sum_idx, num_segments, weights=None):
        return torch.cat([m.frechet_mean(p, sum_idx, num_segments, weights)
                          for m, p in self._split(x)], -1)
