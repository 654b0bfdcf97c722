"""Multi-device graph training, counterpart of `gammagl_tpu/parallel/`.

So far only the host-side node orderings that the single-card block-pair
route uses (`Graph.reorder_rcm`, `Graph.reorder_cluster`): the
partitions, halo exchanges and their kernels follow with
``torch.distributed``.
"""

from gammagl_tpu_torch.parallel.halo import reorder_bandwidth  # noqa: F401
from gammagl_tpu_torch.parallel.partition import (  # noqa: F401
    cluster_permutation,
)

__all__ = ["reorder_bandwidth", "cluster_permutation"]
