"""MinCut pooling (counterpart of `gammagl_tpu/layers/pool/mincut.py`;
Bianchi et al., "Spectral Clustering with Graph Neural Networks for Graph
Pooling").

``dense_mincut_pool(x, adj, s)`` is the dense formulation on an (N, N)
adjacency. ``sparse_mincut_losses(s, edge_index, num_nodes)`` gives the
same two losses from the edge list: they need only the traces of S^T A S
(a dot product an edge) and S^T D S (degree-weighted row norms), so no
N x N adjacency is formed.
"""

import torch

from gammagl_tpu_torch.ops.segment import segment_sum

__all__ = ["dense_mincut_pool", "sparse_mincut_losses"]

_EPS = 1e-10


def _losses(mincut_num, mincut_den, ss, k):
    """(the mincut loss, the orthogonality loss) from the two traces and
    S^T S (k, k)."""
    mincut_loss = -(mincut_num / (mincut_den + _EPS))
    i_s = torch.eye(k, dtype=ss.dtype, device=ss.device)
    ss_norm = ss / (ss.square().sum().sqrt() + _EPS)
    i_s_norm = i_s / (i_s.square().sum().sqrt() + _EPS)
    return mincut_loss, (ss_norm - i_s_norm).square().sum().sqrt()


def dense_mincut_pool(x, adj, s, temp=1.0):
    """``s``: pre-softmax cluster logits (N, k), softmaxed here (over k,
    at temperature ``temp``). Returns (S^T X, S^T A S, mincut loss,
    orthogonality loss)."""
    s = torch.softmax(s / temp, dim=-1)
    out_adj = s.T @ adj @ s
    d = adj.sum(1)
    mincut_den = torch.trace((s * d[:, None]).T @ s)
    mincut_loss, ortho_loss = _losses(torch.trace(out_adj), mincut_den,
                                      s.T @ s, s.shape[-1])
    return s.T @ x, out_adj, mincut_loss, ortho_loss


def sparse_mincut_losses(s, edge_index, num_nodes, edge_weight=None,
                         temp=1.0):
    """The mincut and orthogonality losses of `dense_mincut_pool` from
    the edge list: trace(S^T A S) = sum_e w_e <S[src_e], S[dst_e]>, and
    trace(S^T D S) = sum_i d_i |S_i|^2 with d the (weighted) out-degree,
    the adjacency's row sums."""
    s = torch.softmax(s / temp, dim=-1)
    src, dst = edge_index[0].long(), edge_index[1].long()
    w = (torch.ones(src.shape[0], dtype=s.dtype, device=s.device)
         if edge_weight is None else edge_weight.to(s.dtype))
    mincut_num = (w * (s[src] * s[dst]).sum(-1)).sum()
    deg = segment_sum(w, src, num_nodes)
    mincut_den = (deg * (s * s).sum(-1)).sum()
    return _losses(mincut_num, mincut_den, s.T @ s, s.shape[-1])
