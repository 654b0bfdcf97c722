"""Attention-path primitives over a CSR plan (counterpart of
`gammagl_tpu/ops/pallas/attention.py`).

The JAX package gathers source rows in its plan's padded lane order
(`plan_gather_src`) or, for window plans, in its compact dst-sorted order
(`plan_gather_src_compact`). A CSR has one order, so both are
`gather_rows(x, plan, "src")`, and `plan_gather_dst` is its ``"dst"``
form, `expand_dst_csr`.

`segment_softmax_padded` and `bspmm_csr` are the softmax and the weighted
multi-head sum of per-edge scores in that CSR order, for layers that must
hold the attention weights themselves (SimpleHGN returns them for the next
layer's blend, so it cannot take the fused flash kernel). The JAX package
runs XLA segment ops for the softmax and one matrix-unit SpMM a head; here
both run on the port's kernels over the plan, with no atomic scatter, so
the results are deterministic.
"""

import torch

from gammagl_tpu_torch.ops.cuda.sddmm_csr import expand_dst_csr
from gammagl_tpu_torch.ops.cuda.segment_matmul import (gather_rows,
                                                       segment_sum_csr,
                                                       spmm_csr)
from gammagl_tpu_torch.ops.cuda.segment_max import segment_max_csr

__all__ = ["plan_gather_src", "plan_gather_src_compact", "plan_gather_dst",
           "segment_softmax_padded", "bspmm_csr"]


def plan_gather_src(x, plan):
    """x[src_e] per CSR edge; the backward is `spmm_csr`."""
    return gather_rows(x, plan, "src")


plan_gather_src_compact = plan_gather_src


def plan_gather_dst(x, plan):
    """x[dst_e] per CSR edge; the backward is `segment_sum_csr`."""
    return gather_rows(x, plan, "dst")


def segment_softmax_padded(scores, plan):
    """Softmax of per-edge scores (E, ...) in the plan's CSR order over
    each destination's edges, computed in float32 and returned in the
    scores' dtype, by the JAX function's rules: a row whose max is -inf
    shifts by 0 (so its entries give 0, not NaN), and the denominator gets
    1e-16.

    On the card: the row max by the segment max kernel (per-edge form),
    broadcast back to the edges by the expand kernel, the denominator by
    the per-edge segment sum; the max carries no gradient (a softmax does
    not change with a per-row shift). Differentiable once in ``scores``.
    """
    if scores.shape[0] != plan.num_edges:
        raise ValueError(f"scores have {scores.shape[0]} rows, the plan has "
                         f"{plan.num_edges} edges")
    s = scores.float().reshape(plan.num_edges, -1).contiguous()
    with torch.no_grad():
        shift = expand_dst_csr(segment_max_csr(s, plan), plan)
    exp = torch.exp(s - shift)
    denom = expand_dst_csr(segment_sum_csr(exp, plan), plan)
    return (exp / (denom + 1e-16)).view(scores.shape).to(scores.dtype)


def bspmm_csr(x_heads, alpha, plan):
    """Multi-head weighted sum: out[d, h] = sum_e alpha[e, h] x[src_e, h].

    x_heads (N_src, H, F); alpha (E, H) in the plan's CSR order ->
    (N_dst, H, F) of x's dtype, summed in float32. One `spmm_csr` a head
    with the head's weights (``weights_padded=True``), as the JAX function
    runs one segment matmul a head; its backward is the kernels' own: dx
    by `spmm_csr` on the transpose plan, dalpha by the SDDMM kernel.
    """
    N, H, F = x_heads.shape
    if alpha.shape != (plan.num_edges, H):
        raise ValueError(f"alpha shape {tuple(alpha.shape)} != "
                         f"({plan.num_edges}, {H})")
    # unbind, not indexing: the backward of H selects would write H full
    # zero-filled gradients and add them up
    heads = x_heads.transpose(0, 1).contiguous().unbind(0)
    return torch.stack([spmm_csr(x, a, plan, weights_padded=True)
                        for x, a in zip(heads, alpha.unbind(1))], 1)
