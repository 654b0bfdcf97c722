"""Message-passing ops: plain PyTorch segment reductions, edge softmax,
COO SpMM and SDDMM, with the kernels of `gammagl_tpu_torch.ops.cuda` (CSR
SpMM and segment sum, block-pair SpMM, segment max and min, fused edge
attention, HGT attention, destination expand and SDDMM) for the plan
path."""

from gammagl_tpu_torch.ops.segment import (  # noqa: F401
    segment_count,
    segment_max,
    segment_mean,
    segment_min,
    segment_sum,
    unsorted_segment_max,
    unsorted_segment_mean,
    unsorted_segment_min,
    unsorted_segment_sum,
)
from gammagl_tpu_torch.ops.sparse import (  # noqa: F401
    ind2ptr,
    ind2ptr_np,
    ptr2ind,
    ptr2ind_np,
    unique_np,
)
from gammagl_tpu_torch.ops.softmax import segment_softmax  # noqa: F401
from gammagl_tpu_torch.ops.spmm import bspmm, gspmm, spmm  # noqa: F401
from gammagl_tpu_torch.ops.sddmm import sddmm, sddmm_dot  # noqa: F401
from gammagl_tpu_torch.ops.cuda import (  # noqa: F401
    CSRPlan,
    build_csr_plan,
    build_csr_plan_blocked,
    pad_edge_weights,
    spmm_csr,
    spmm_csr_reference,
    spmm_csr_acc,
    segment_sum_csr,
    gather_rows,
    expand_dst_csr,
    sddmm_csr,
    sddmm_csr_mh,
    flash_edge_attention,
    flash_edge_attention_mh,
    flash_gat_attention,
    flash_softmax_spmm,
    flash_softmax_spmm_mh,
    hgt_flash_packed,
    segment_max_csr,
    segment_min_csr,
    spmm_max_csr,
    spmm_min_csr,
    BlockPairPlan,
    build_block_pair_plan,
    spmm_block_pair,
    spmm_block_pair_reference,
    HybridPlan,
    build_hybrid_plan,
    spmm_hybrid,
)

__all__ = ["segment_sum", "segment_count", "segment_mean", "segment_max",
           "segment_min", "unsorted_segment_sum", "unsorted_segment_mean",
           "unsorted_segment_max", "unsorted_segment_min", "ind2ptr",
           "ptr2ind", "ind2ptr_np", "ptr2ind_np", "unique_np",
           "segment_softmax", "spmm", "bspmm", "gspmm",
           "sddmm", "sddmm_dot",
           "CSRPlan", "build_csr_plan", "build_csr_plan_blocked",
           "pad_edge_weights", "spmm_csr", "spmm_csr_reference",
           "spmm_csr_acc", "segment_sum_csr", "gather_rows", "expand_dst_csr", "sddmm_csr",
           "sddmm_csr_mh",
           "flash_edge_attention", "flash_edge_attention_mh",
           "flash_gat_attention", "flash_softmax_spmm",
           "flash_softmax_spmm_mh", "spmm_max_csr", "spmm_min_csr",
           "segment_max_csr", "segment_min_csr", "hgt_flash_packed",
           "BlockPairPlan", "build_block_pair_plan", "spmm_block_pair",
           "spmm_block_pair_reference", "HybridPlan", "build_hybrid_plan",
           "spmm_hybrid"]
