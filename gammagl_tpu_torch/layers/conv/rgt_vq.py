"""Vector quantisation on constant-curvature manifolds for RGT
(counterpart of `gammagl_tpu/layers/conv/rgt_vq.py`; reference:
gammagl/layers/conv/{vq_euclidean,vq_riemann}.py).

The configuration RGT uses (learnable codebooks, no EMA, no k-means init,
cosine similarity): each head assigns every row to its nearest code, by
one batched product a head (cosine similarity in flat space, the
manifold's geodesic distance on the sphere and the hyperboloid), passes
the codes on by the straight-through estimator, and returns the
commitment and codebook losses. The codebooks are flax ``param``s of
shape (heads, codebook_size, codebook_dim), normal(0.02) at init.
"""

import torch
from torch import nn

from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.utils.manifold_math import _clip

__all__ = ["VectorQuantizeE", "VectorQuantizeR"]


def _straight_through(x, q):
    """x + stop_gradient(q - x): q's value, x's gradient."""
    return x + (q - x).detach()


def _codebook(heads, size, dim):
    return nn.Parameter(torch.randn(heads, size, dim) * 0.02)


def _gather_codes(codes, ind):
    """codes (h, C, d)[ind (h, N)] -> (h, N, d)."""
    return torch.take_along_dim(codes, ind[..., None], dim=1)


class VectorQuantizeE(nn.Module):
    """Multi-head Euclidean VQ with cosine-similarity codebooks:
    ``project_in`` to ``heads * codebook_dim``, rows and codes normalised,
    each row's code the most similar one, ``project_out`` of the
    straight-through codes, normalised. Returns (quantize, indices (N,
    heads), commitment_weight * commit + codebook loss, similarities
    (heads, N, codebook_size))."""

    def __init__(self, dim, codebook_size, codebook_dim=32, heads=8,
                 commitment_weight=0.25):
        super().__init__()
        self.heads, self.codebook_dim = heads, codebook_dim
        self.commitment_weight = commitment_weight
        self.project_in = lecun_dense(dim, heads * codebook_dim)
        self.project_out = lecun_dense(heads * codebook_dim, dim)
        self.codebook = _codebook(heads, codebook_size, codebook_dim)

    def flax_tree(self):
        return {"project_in": self.project_in,
                "project_out": self.project_out, "codebook": self.codebook}

    def forward(self, x):
        h, cd, n = self.heads, self.codebook_dim, x.shape[0]
        z = lecun_apply(self.project_in, x).reshape(n, h, cd).transpose(0, 1)
        zn = z / torch.sqrt((z * z).sum(-1, keepdim=True) + 1e-12)
        cb = self.codebook
        cn = cb / torch.sqrt((cb * cb).sum(-1, keepdim=True) + 1e-12)
        sim = zn @ cn.transpose(1, 2)                      # (h, N, C)
        ind = sim.argmax(-1)                               # (h, N)
        quant = _gather_codes(cn, ind)
        commit = ((zn - quant.detach()) ** 2).mean()
        codebook_loss = ((zn.detach() - quant) ** 2).mean()
        loss = self.commitment_weight * commit + codebook_loss
        quant = _straight_through(zn, quant)
        out = lecun_apply(self.project_out,
                          quant.transpose(0, 1).reshape(n, h * cd))
        out = out / torch.sqrt((out * out).sum(-1, keepdim=True) + 1e-8)
        return out, ind.T, loss, sim


class VectorQuantizeR(nn.Module):
    """Riemannian VQ: the codebook is kept in the tangent space at the
    origin (``codebook_tangent``) and mapped onto ``manifold`` by
    expmap0(proju0(.)), the rows likewise after ``project_in``; each row's
    code the nearest by geodesic distance (one batched product a head),
    the commitment and codebook losses squared geodesic distances. The
    straight-through codes go through ``project_out`` and back onto the
    manifold. Returns (quantize, indices (N, heads), loss, distances
    (heads, N, codebook_size))."""

    def __init__(self, manifold, dim, codebook_size, codebook_dim=32,
                 heads=8, commitment_weight=0.25):
        super().__init__()
        self.manifold = manifold
        self.heads, self.codebook_dim = heads, codebook_dim
        self.commitment_weight = commitment_weight
        self.project_in = lecun_dense(dim, heads * codebook_dim)
        self.project_out = lecun_dense(heads * codebook_dim, dim)
        self.codebook_tangent = _codebook(heads, codebook_size, codebook_dim)

    def flax_tree(self):
        return {"project_in": self.project_in,
                "project_out": self.project_out,
                "codebook_tangent": self.codebook_tangent}

    def forward(self, x):
        h, cd, n = self.heads, self.codebook_dim, x.shape[0]
        m = self.manifold
        codes = m.expmap0(m.proju0(self.codebook_tangent))   # (h, C, cd)
        z = lecun_apply(self.project_in, x).reshape(n, h, cd).transpose(0, 1)
        z = m.expmap0(m.proju0(z))                           # (h, N, cd)
        dist = m.pairwise_dist(z, codes)                     # (h, N, C)
        ind = dist.argmin(-1)
        quant = _gather_codes(codes, ind)
        commit = (m.dist(z, quant.detach()) ** 2).mean()
        codebook_loss = (m.dist(z.detach(), quant) ** 2).mean()
        loss = self.commitment_weight * commit + codebook_loss
        quant = _straight_through(z, quant)
        out = lecun_apply(self.project_out,
                          quant.transpose(0, 1).reshape(n, h * cd))
        denorm = torch.sqrt(_clip(m.inner(None, out, keepdim=True).abs(),
                                  1e-8))
        out = out / (m.k ** 0.5 * denorm)
        return out, ind.T, loss, dist
