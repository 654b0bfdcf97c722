"""Hand-written Hopper kernels for the hot message-passing primitives and
the planned halo tier's accumulating SpMM.

Counterpart of `gammagl_tpu.ops.pallas`. Each kernel is CUDA C++ under
``gammagl_tpu_torch/csrc/``, built at first use (`_build`); nothing is
compiled or loaded when this package is imported.
"""

from gammagl_tpu_torch.ops.cuda.segment_matmul import (  # noqa: F401
    CSRPlan,
    ROW_SPLIT,
    build_csr_plan,
    build_csr_plan_blocked,
    build_row_split,
    csr_fold,
    gather_rows,
    pad_edge_weights,
    segment_sum_csr,
    segment_sum_csr_reference,
    spmm_csr,
    spmm_csr_acc,
    spmm_csr_acc_reference,
    spmm_csr_reference,
)
from gammagl_tpu_torch.ops.cuda.sddmm_csr import (  # noqa: F401
    expand_dst_csr,
    expand_dst_csr_reference,
    sddmm_csr,
    sddmm_csr_mh,
    sddmm_csr_reference,
)
from gammagl_tpu_torch.ops.cuda.attention import (  # noqa: F401
    bspmm_csr,
    plan_gather_dst,
    plan_gather_src,
    plan_gather_src_compact,
    segment_softmax_padded,
)
from gammagl_tpu_torch.ops.cuda.segment_max import (  # noqa: F401
    segment_max_bwd,
    segment_max_bwd_reference,
    segment_max_count,
    segment_max_count_fold,
    segment_max_csr,
    segment_max_csr_reference,
    segment_max_fold,
    segment_min_csr,
    segment_min_csr_reference,
    spmm_max_csr,
    spmm_max_csr_reference,
    spmm_min_csr,
    spmm_min_csr_reference,
)
from gammagl_tpu_torch.ops.cuda.hetero_flash import (  # noqa: F401
    hgt_backward,
    hgt_backward_reference,
    hgt_flash_packed,
    hgt_forward,
    hgt_forward_reference,
)
from gammagl_tpu_torch.ops.cuda.block_pair import (  # noqa: F401
    BlockPairPlan,
    HybridPlan,
    block_pair_dw,
    block_pair_dw_reference,
    build_block_pair_plan,
    build_hybrid_plan,
    spmm_block_pair,
    spmm_block_pair_reference,
    spmm_hybrid,
)
from gammagl_tpu_torch.ops.cuda.flash_attention import (  # noqa: F401
    attention_keep_mask,
    flash_backward,
    flash_backward_reference,
    flash_edge_attention,
    flash_edge_attention_mh,
    flash_forward,
    flash_forward_reference,
    flash_fwd_fold,
    flash_gat_attention,
    flash_softmax_spmm,
    flash_softmax_spmm_mh,
)

__all__ = ["CSRPlan", "build_csr_plan", "build_csr_plan_blocked",
           "build_row_split", "ROW_SPLIT", "csr_fold",
           "pad_edge_weights", "spmm_csr", "spmm_csr_reference",
           "spmm_csr_acc", "spmm_csr_acc_reference", "attention_keep_mask", "flash_edge_attention",
           "flash_edge_attention_mh", "flash_softmax_spmm",
           "flash_softmax_spmm_mh", "flash_gat_attention", "flash_forward",
           "flash_backward", "flash_fwd_fold", "flash_forward_reference",
           "flash_backward_reference", "segment_sum_csr",
           "segment_sum_csr_reference", "gather_rows", "expand_dst_csr",
           "expand_dst_csr_reference", "sddmm_csr", "sddmm_csr_mh",
           "sddmm_csr_reference", "plan_gather_src",
           "plan_gather_src_compact", "plan_gather_dst",
           "segment_softmax_padded", "bspmm_csr", "spmm_max_csr",
           "spmm_min_csr", "segment_max_csr", "segment_min_csr",
           "spmm_max_csr_reference", "spmm_min_csr_reference",
           "segment_max_csr_reference", "segment_min_csr_reference",
           "segment_max_bwd", "segment_max_bwd_reference",
           "segment_max_fold", "segment_max_count",
           "segment_max_count_fold",
           "hgt_flash_packed", "hgt_forward", "hgt_backward",
           "hgt_forward_reference", "hgt_backward_reference",
           "BlockPairPlan", "build_block_pair_plan", "spmm_block_pair",
           "spmm_block_pair_reference", "block_pair_dw",
           "block_pair_dw_reference", "HybridPlan", "build_hybrid_plan",
           "spmm_hybrid"]
