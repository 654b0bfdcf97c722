"""Multi-device graph training, counterpart of `gammagl_tpu/parallel/`.

The node orderings (RCM, label propagation, degree balance), the halo
partitions and their SpMM tiers over ``torch.distributed`` (the flat tier
and the planned tier, whose sums run the CSR SpMM kernels), and the
full-graph GCN recipes on them. One process owns one part; a partition of
one part runs in one process with no group.
"""

from gammagl_tpu_torch.parallel.full_graph import (  # noqa: F401
    estimate_hbm_gb,
    make_partitioned_gcn_train,
    make_partitioned_gcn_train_staged,
    pad_nodes,
    params_from_jax,
    shard_nodes,
    sign_precompute,
    unpad_nodes,
)
from gammagl_tpu_torch.parallel.halo import (  # noqa: F401
    HaloPartition,
    build_halo_partition,
    make_halo_spmm,
    reorder_bandwidth,
)
from gammagl_tpu_torch.parallel.halo_plan import (  # noqa: F401
    PlannedHaloPartition,
    auto_src_blocks,
    build_halo_partition_planned,
    make_halo_spmm_planned,
    make_halo_spmm_planned_pair,
)
from gammagl_tpu_torch.parallel.mesh import part_world, world  # noqa: F401
from gammagl_tpu_torch.parallel.partition import (  # noqa: F401
    balance_permutation,
    cluster_permutation,
)

__all__ = ["reorder_bandwidth", "cluster_permutation", "balance_permutation",
           "world", "part_world", "HaloPartition", "build_halo_partition",
           "make_halo_spmm", "PlannedHaloPartition", "auto_src_blocks",
           "build_halo_partition_planned", "make_halo_spmm_planned",
           "make_halo_spmm_planned_pair", "pad_nodes", "unpad_nodes",
           "shard_nodes", "sign_precompute", "make_partitioned_gcn_train",
           "make_partitioned_gcn_train_staged", "estimate_hbm_gb",
           "params_from_jax"]
