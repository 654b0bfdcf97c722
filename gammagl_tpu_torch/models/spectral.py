"""Spectral-filter models: Specformer and MGNNI (counterparts of
`gammagl_tpu/models/spectral.py`; reference:
gammagl/models/{specformer,mgnni}.py, gammagl/layers/conv/mgnni_m_iter.py).

Specformer is dense algebra on a host eigendecomposition
(`laplacian_eigh`, numpy and scipy). It keeps flax's defaults where
PyTorch's differ: LayerNorm's epsilon is 1e-6, GELU is the tanh
approximation, and the self-attention keeps flax's ``SelfAttention``
parameters in their own shapes (q / k / v kernels (F, heads, F/heads),
the out kernel (heads, F/heads, F)) and scales the queries by
1/sqrt(F/heads). MGNNI iterates the COO `spmm` with the symmetric GCN
weights, as in JAX (no plan).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv.simple_convs import _gcn_weights
from gammagl_tpu_torch.layers.dense import (dropout, fan_in_normal_,
                                            lecun_apply, lecun_dense)
from gammagl_tpu_torch.ops import spmm

__all__ = ["SpecformerModel", "laplacian_eigh", "MGNNIModel"]


def laplacian_eigh(edge_index, num_nodes, k=None):
    """Host-side eigendecomposition of the symmetric-normalised Laplacian
    of the symmetrised graph. Returns (eigenvalues (K,), eigenvectors
    (N, K)) in float32; ``k=None`` (or k >= N - 1) is the full
    decomposition, else the ``k`` smallest by ``eigsh``."""
    import scipy.sparse as sp
    ei = np.asarray(edge_index)
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float64)
    deg = np.asarray(a.sum(1)).reshape(-1)
    with np.errstate(divide="ignore"):
        dis = np.where(deg > 0, deg ** -0.5, 0.0)
    lap = sp.eye(num_nodes) - sp.diags(dis) @ a @ sp.diags(dis)
    if k is None or k >= num_nodes - 1:
        w, v = np.linalg.eigh(lap.toarray())
    else:
        from scipy.sparse.linalg import eigsh
        w, v = eigsh(lap.tocsc(), k=k, which="SM")
    return w.astype(np.float32), v.astype(np.float32)


def _eig_encoding(lam, dim):
    """Sinusoidal eigenvalue encoding (Specformer eq. 3): the eigenvalue,
    then the sines and cosines of dim // 2 frequencies, 1 + 2 * (dim // 2)
    columns."""
    d = dim // 2
    freqs = torch.exp(torch.arange(d, device=lam.device, dtype=lam.dtype)
                      * (-np.log(10000.0) / d))
    ang = lam[:, None] * freqs[None] * 100
    return torch.cat([lam[:, None], torch.sin(ang), torch.cos(ang)], dim=-1)


class _DenseGeneral(nn.Module):
    """A flax ``DenseGeneral`` of the attention: ``kernel`` and ``bias`` in
    their flax shapes, the kernel lecun-normal over ``fan_in``, the bias
    zero."""

    def __init__(self, kernel_shape, bias_shape, fan_in):
        super().__init__()
        self.kernel = nn.Parameter(fan_in_normal_(torch.empty(kernel_shape),
                                                  1.0, fan_in))
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def flax_tree(self):
        return {"kernel": self.kernel, "bias": self.bias}


class _SelfAttention(nn.Module):
    """flax's ``SelfAttention`` (``query``, ``key``, ``value``, ``out``) on
    sequences (..., L, F), no dropout: per head softmax(q k^T / sqrt(D)) v,
    the heads mapped back to F. ``mask`` (bool, broadcast to (..., heads,
    L, L); True attends) fills the scores it masks with the dtype's
    finfo min before the softmax, as flax does (not -inf)."""

    def __init__(self, features, num_heads):
        super().__init__()
        head = features // num_heads
        for name in ("query", "key", "value"):
            setattr(self, name, _DenseGeneral((features, num_heads, head),
                                              (num_heads, head), features))
        self.out = _DenseGeneral((num_heads, head, features), (features,),
                                 features)

    def flax_tree(self):
        return {"query": self.query, "key": self.key, "value": self.value,
                "out": self.out}

    def forward(self, h, mask=None):
        q, k, v = (torch.einsum("...lf,fhd->...lhd", h, m.kernel) + m.bias
                   for m in (self.query, self.key, self.value))
        q = q / math.sqrt(q.shape[-1])
        s = torch.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            s = s.masked_fill(~mask, torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("...hqk,...khd->...qhd", w, v)
        return torch.einsum("...qhd,hdf->...qf", out, self.out.kernel) + \
            self.out.bias


class SpecformerModel(nn.Module):
    """Specformer (Bo 2023; reference specformer.py): a set-to-set
    transformer over the Laplacian's eigenvalues gives ``num_filters``
    learned spectral filters; each convolves the mapped features as
    U diag(filter_m) U^T X. flax names: the eigenvalue map ``Dense_0``,
    ``SelfAttention_0``, ``LayerNorm_0``, the feed-forward ``Dense_2``
    (F -> 2F) then ``Dense_1`` (2F -> F), ``LayerNorm_1``, the filter map
    ``Dense_3``, the feature map ``Dense_4``, the classifier ``Dense_5``.
    Dropout (training mode) draws from ``generator``.
    """

    def __init__(self, num_class, hidden_dim=32, num_heads=4, num_filters=4,
                 drop_rate=0.2, in_channels=None):
        super().__init__()
        self.hidden_dim, self.num_filters = hidden_dim, num_filters
        self.drop_rate = drop_rate
        self.eig = lecun_dense(1 + 2 * (hidden_dim // 2), hidden_dim)
        self.attn = _SelfAttention(hidden_dim, num_heads)
        self.norm0 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.ff_out = lecun_dense(2 * hidden_dim, hidden_dim)
        self.ff_in = lecun_dense(hidden_dim, 2 * hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-6)
        self.filt = lecun_dense(hidden_dim, num_filters)
        self.feat = lecun_dense(in_channels, hidden_dim)
        self.head = lecun_dense((1 + num_filters) * hidden_dim, num_class)

    def flax_tree(self):
        return {"Dense_0": self.eig, "SelfAttention_0": self.attn,
                "LayerNorm_0": self.norm0, "Dense_1": self.ff_out,
                "Dense_2": self.ff_in, "LayerNorm_1": self.norm1,
                "Dense_3": self.filt, "Dense_4": self.feat,
                "Dense_5": self.head}

    def _drop(self, x, generator):
        return dropout(x, self.drop_rate if self.training else 0.0,
                       generator)

    def forward(self, x, eigenvalues, eigenvectors, generator=None):
        lam, u = eigenvalues, eigenvectors  # (K,), (N, K)
        h = self.eig(_eig_encoding(lam, self.hidden_dim))
        h = self.norm0(h + self.attn(h))
        ff = self.ff_out(F.gelu(self.ff_in(h), approximate="tanh"))
        h = self.norm1(h + ff)
        filters = self.filt(h) + lam[:, None]  # (K, M) new eigenvalues
        x = self._drop(x, generator)
        x = F.relu(lecun_apply(self.feat, x))
        spec = u.T @ x  # (K, F)
        outs = [x] + [u @ (filters[:, m:m + 1] * spec)
                      for m in range(self.num_filters)]
        out = self._drop(torch.cat(outs, dim=-1), generator)
        return self.head(out)


class MGNNIModel(nn.Module):
    """Multiscale implicit GNN (Liu 2022; reference mgnni.py,
    mgnni_m_iter.py): for each scale m, ``iters`` steps of
    z <- gamma * (A_hat^m z) W_m + f(x) from z = 0 (unrolled, so autograd
    runs through them), W_m divided by its spectral norm (+1e-6); the
    scales concatenated and classified. flax names: f ``Dense_0``, the
    classifier ``Dense_1``, the orthogonal-initialised ``w_{m}``."""

    def __init__(self, num_class, hidden_dim=64, scales=(1, 2), gamma=0.8,
                 iters=10, in_channels=None):
        super().__init__()
        self.scales, self.gamma, self.iters = tuple(scales), gamma, iters
        self.fx = lecun_dense(in_channels, hidden_dim)
        self.ws = nn.ParameterList(
            nn.Parameter(nn.init.orthogonal_(torch.empty(hidden_dim,
                                                         hidden_dim)))
            for _ in self.scales)
        self.head = lecun_dense(len(self.scales) * hidden_dim, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.fx, "Dense_1": self.head}
        tree.update({f"w_{m}": w for m, w in zip(self.scales, self.ws)})
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        fx = lecun_apply(self.fx, x)
        outs = []
        for m, wm in zip(self.scales, self.ws):
            # spectral-radius control: W / ||W||_2 (the largest singular
            # value), the reference's projection step
            wm = wm / (torch.linalg.matrix_norm(wm, ord=2) + 1e-6)
            z = torch.zeros_like(fx)
            for _ in range(self.iters):
                az = z
                for _ in range(m):
                    az = spmm(edge_index, w, az, num_nodes=num_nodes)
                z = self.gamma * az @ wm + fx
            outs.append(z)
        return self.head(torch.cat(outs, dim=-1))
