"""Message-passing ops: plain PyTorch segment reductions and COO SpMM,
with the CSR SpMM kernel of `gammagl_tpu_torch.ops.cuda` for the
plan path."""

from gammagl_tpu_torch.ops.segment import (  # noqa: F401
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
)
from gammagl_tpu_torch.ops.spmm import gspmm, spmm  # noqa: F401
from gammagl_tpu_torch.ops.cuda import (  # noqa: F401
    CSRPlan,
    build_csr_plan,
    build_csr_plan_blocked,
    pad_edge_weights,
    spmm_csr,
    spmm_csr_reference,
)

__all__ = ["segment_sum", "segment_count", "segment_mean", "segment_max",
           "segment_min", "spmm", "gspmm", "CSRPlan", "build_csr_plan",
           "build_csr_plan_blocked", "pad_edge_weights", "spmm_csr",
           "spmm_csr_reference"]
