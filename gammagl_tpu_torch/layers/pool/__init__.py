"""Graph pooling: global readouts and MinCut pooling."""

from gammagl_tpu_torch.layers.pool.glob import (  # noqa: F401
    global_add_pool,
    global_max_pool,
    global_mean_pool,
    global_min_pool,
    global_sort_pool,
    global_sum_pool,
)
from gammagl_tpu_torch.layers.pool.mincut import (  # noqa: F401
    dense_mincut_pool,
    sparse_mincut_losses,
)

__all__ = ["global_sum_pool", "global_add_pool", "global_mean_pool",
           "global_max_pool", "global_min_pool", "global_sort_pool",
           "dense_mincut_pool", "sparse_mincut_losses"]
