"""Multi-device graph training, counterpart of `gammagl_tpu/parallel/`.

The node orderings (RCM, label propagation, degree balance), the edge
partitions and the edge-sharded SpMM, the feature-sharded, relation-expert
and pipeline strategies, the halo partitions and their SpMM tiers over
``torch.distributed`` (the flat tier and the planned tier, whose sums run
the CSR SpMM kernels, each on P parts or on a two-level slice x dp grid),
the partitioned GAT layer on the flash attention kernels, the full-graph
GCN and GAT recipes on them, and the scaling model. One process owns one
part; a partition of one part runs in one process with no group.
"""

from gammagl_tpu_torch.parallel.full_graph import (  # noqa: F401
    estimate_hbm_gb,
    make_partitioned_gat_train,
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
from gammagl_tpu_torch.parallel.halo_attention import (  # noqa: F401
    AttnHaloPartition,
    build_halo_partition_attn,
    make_partitioned_gat_layer,
)
from gammagl_tpu_torch.parallel.halo_plan import (  # noqa: F401
    PlannedHaloPartition,
    PlannedHierHaloPartition,
    auto_src_blocks,
    build_halo_partition_planned,
    build_hier_halo_partition_planned,
    make_halo_spmm_planned,
    make_halo_spmm_planned_pair,
    make_hier_halo_spmm_planned,
    make_hier_halo_spmm_planned_pair,
)
from gammagl_tpu_torch.parallel.hier_halo import (  # noqa: F401
    HierHaloPartition,
    build_hier_halo_partition,
    make_hier_halo_spmm,
    traffic_report,
)
from gammagl_tpu_torch.parallel.mesh import (  # noqa: F401
    DpTpGrid,
    HierGrid,
    grid_world,
    hier_world,
    part_world,
    world,
)
from gammagl_tpu_torch.parallel.partition import (  # noqa: F401
    EdgePartition,
    balance_permutation,
    cluster_permutation,
    partition_edges_by_dst,
    partition_edges_uniform,
)
from gammagl_tpu_torch.parallel.scaling import (  # noqa: F401
    HwModel,
    halo_scaling_estimate,
)
from gammagl_tpu_torch.parallel.spmm import (  # noqa: F401
    make_sharded_spmm,
    sharded_spmm,
)
from gammagl_tpu_torch.parallel.strategies import (  # noqa: F401
    make_feature_sharded_spmm,
    make_pipeline_apply,
    make_relation_expert_spmm,
    pipeline_apply,
    relation_expert_spmm,
    shard_expert_weights,
    shard_pipeline_params,
)

__all__ = ["reorder_bandwidth", "cluster_permutation", "balance_permutation",
           "EdgePartition", "partition_edges_by_dst",
           "partition_edges_uniform", "sharded_spmm", "make_sharded_spmm",
           "pipeline_apply", "make_pipeline_apply", "shard_pipeline_params",
           "make_feature_sharded_spmm", "relation_expert_spmm",
           "make_relation_expert_spmm", "shard_expert_weights", "world", "part_world", "HierGrid", "hier_world",
           "DpTpGrid", "grid_world", "HaloPartition",
           "build_halo_partition", "make_halo_spmm", "HierHaloPartition",
           "build_hier_halo_partition", "make_hier_halo_spmm",
           "traffic_report", "PlannedHaloPartition", "auto_src_blocks",
           "build_halo_partition_planned", "make_halo_spmm_planned",
           "make_halo_spmm_planned_pair", "PlannedHierHaloPartition",
           "build_hier_halo_partition_planned",
           "make_hier_halo_spmm_planned",
           "make_hier_halo_spmm_planned_pair", "AttnHaloPartition",
           "build_halo_partition_attn", "make_partitioned_gat_layer",
           "pad_nodes", "unpad_nodes", "shard_nodes", "sign_precompute",
           "make_partitioned_gcn_train", "make_partitioned_gcn_train_staged",
           "make_partitioned_gat_train", "estimate_hbm_gb",
           "params_from_jax", "HwModel", "halo_scaling_estimate"]
