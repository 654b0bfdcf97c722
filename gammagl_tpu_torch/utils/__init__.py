"""Graph and model utilities."""

from gammagl_tpu_torch.utils.compute_dtype import (  # noqa: F401
    compute_dtype,
    get_compute_dtype,
    resolve_dtype,
    set_compute_dtype,
)
from gammagl_tpu_torch.utils.coalesce import (  # noqa: F401
    coalesce,
    sort_edge_index,
)
from gammagl_tpu_torch.utils.degree import degree  # noqa: F401
from gammagl_tpu_torch.utils.device import (  # noqa: F401
    resolve_device,
    to_device,
)
from gammagl_tpu_torch.utils.mask import (  # noqa: F401
    index_to_mask,
    mask_to_index,
)
from gammagl_tpu_torch.utils.loop import (  # noqa: F401
    add_self_loops,
    contains_self_loops,
    remove_self_loops,
)
from gammagl_tpu_torch.utils.norm import (  # noqa: F401
    calc_gcn_norm,
    calc_gcn_norm_np,
)
from gammagl_tpu_torch.utils.negative_sampling import (  # noqa: F401
    batched_negative_sampling,
    negative_sampling,
    structured_negative_sampling,
)
from gammagl_tpu_torch.utils.params import load_jax_params  # noqa: F401
from gammagl_tpu_torch.utils.misc import (  # noqa: F401
    from_scipy_sparse_matrix,
    get_laplacian,
    get_train_val_test_split,
    homophily,
    to_scipy_sparse_matrix,
)
from gammagl_tpu_torch.utils.pruning import (  # noqa: F401
    prune_edges_by_weight,
    prune_params,
    rewind,
    sparsity,
    threshold_prune,
)
from gammagl_tpu_torch.utils.unifews_log import (  # noqa: F401
    F1Calculator,
    LayerNumLogger,
    ModelLogger,
    Stopwatch,
    UniFewsLogger,
)
from gammagl_tpu_torch.utils.subgraph import (  # noqa: F401
    k_hop_subgraph,
    subgraph,
)
from gammagl_tpu_torch.utils.undirected import (  # noqa: F401
    is_undirected,
    to_undirected,
)
from gammagl_tpu_torch.utils.to_dense import (  # noqa: F401
    to_dense_adj,
    to_dense_batch,
)
from gammagl_tpu_torch.utils.shortest_path import shortest_path  # noqa: F401
from gammagl_tpu_torch.utils import manifold_math  # noqa: F401
from gammagl_tpu_torch.utils.smiles import from_smiles  # noqa: F401
from gammagl_tpu_torch.utils.profiling import (  # noqa: F401
    chain_time,
    device_timer,
    trace,
)
from gammagl_tpu_torch.utils import gfm_utils  # noqa: F401
from gammagl_tpu_torch.utils.conversation import (  # noqa: F401
    Conversation,
    conv_templates,
    get_conv_template,
)
from gammagl_tpu_torch.utils.paths_io import (  # noqa: F401
    Inspector,
    find_all_simple_paths,
    read_embeddings,
    save_embeddings,
)
from gammagl_tpu_torch.utils.compat_utils import (  # noqa: F401
    batched_shortest_path_distance,
    calc_A_norm_hat,
    edge_index_to_adj_matrix,
    get_few_shot_split,
    node_subgraph,
    set_device,
    shortest_path_distance,
)
# re-exported from ops, as the JAX package's utils does (last: ops imports
# utils' submodules)
from gammagl_tpu_torch.ops.softmax import segment_softmax  # noqa: F401,E402

__all__ = ["add_self_loops", "remove_self_loops", "contains_self_loops",
           "calc_gcn_norm", "calc_gcn_norm_np", "compute_dtype",
           "get_compute_dtype", "resolve_dtype", "set_compute_dtype",
           "load_jax_params", "resolve_device", "to_device", "degree",
           "mask_to_index", "index_to_mask", "coalesce", "sort_edge_index",
           "to_undirected", "is_undirected", "to_dense_adj",
           "to_dense_batch", "subgraph", "k_hop_subgraph",
           "negative_sampling", "batched_negative_sampling",
           "structured_negative_sampling", "homophily", "get_laplacian",
           "to_scipy_sparse_matrix", "from_scipy_sparse_matrix",
           "get_train_val_test_split", "threshold_prune", "prune_params",
           "rewind", "sparsity", "prune_edges_by_weight", "UniFewsLogger",
           "ModelLogger", "LayerNumLogger", "F1Calculator", "Stopwatch",
           "shortest_path", "manifold_math", "chain_time", "trace",
           "device_timer", "calc_A_norm_hat", "edge_index_to_adj_matrix",
           "get_few_shot_split", "node_subgraph", "set_device",
           "shortest_path_distance", "batched_shortest_path_distance",
           "segment_softmax", "from_smiles", "gfm_utils", "Conversation",
           "conv_templates", "get_conv_template", "find_all_simple_paths",
           "read_embeddings", "save_embeddings", "Inspector"]
