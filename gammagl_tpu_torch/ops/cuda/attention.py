"""Attention-path gathers over a CSR plan (counterpart of
`gammagl_tpu/ops/pallas/attention.py`).

The JAX package gathers source rows in its plan's padded lane order
(`plan_gather_src`) or, for window plans, in its compact dst-sorted order
(`plan_gather_src_compact`). A CSR has one order, so both are
`gather_rows(x, plan, "src")`, and `plan_gather_dst` is its ``"dst"``
form, `expand_dst_csr`.
"""

from gammagl_tpu_torch.ops.cuda.segment_matmul import gather_rows

__all__ = ["plan_gather_src", "plan_gather_src_compact", "plan_gather_dst"]


def plan_gather_src(x, plan):
    """x[src_e] per CSR edge; the backward is `spmm_csr`."""
    return gather_rows(x, plan, "src")


plan_gather_src_compact = plan_gather_src


def plan_gather_dst(x, plan):
    """x[dst_e] per CSR edge; the backward is `segment_sum_csr`."""
    return gather_rows(x, plan, "dst")
