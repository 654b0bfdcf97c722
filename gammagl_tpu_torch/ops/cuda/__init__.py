"""Hand-written Hopper kernels for the hot message-passing primitives.

Counterpart of `gammagl_tpu.ops.pallas`. Each kernel is CUDA C++ under
``gammagl_tpu_torch/csrc/``, built at first use (`_build`); nothing is
compiled or loaded when this package is imported.
"""

from gammagl_tpu_torch.ops.cuda.segment_matmul import (  # noqa: F401
    CSRPlan,
    build_csr_plan,
    build_csr_plan_blocked,
    pad_edge_weights,
    spmm_csr,
    spmm_csr_reference,
)

__all__ = ["CSRPlan", "build_csr_plan", "build_csr_plan_blocked",
           "pad_edge_weights", "spmm_csr", "spmm_csr_reference"]
