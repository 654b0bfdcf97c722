"""Loaders (counterpart of `gammagl_tpu/loader/`; reference:
gammagl/loader/).

Ported: the graph DataLoader, the node, link and layered neighbour
loaders over the C++ sampler, GraphSAINT, random walks, the typed-graph
sampler, the epoch cache, the feature table on the card and its form cut
into row blocks over a process group (`ShardedFeatureStore`), prefetching
onto the card, RGT's structure loaders, and the multi-process input
pipeline (`multihost.py`: seed shards, padded buckets, this process's
block of a global batch).
"""

from gammagl_tpu_torch.loader.dataloader import DataLoader, Collater
from gammagl_tpu_torch.loader.node_loader import (NodeLoader,
                                                  NodeNeighborLoader,
                                                  filter_graph)
from gammagl_tpu_torch.loader.link_loader import (LinkLoader,
                                                  LinkNeighborLoader)
from gammagl_tpu_torch.loader.graph_saint import (
    GraphSAINTSampler, GraphSAINTNodeSampler, GraphSAINTRandomWalkSampler)
from gammagl_tpu_torch.loader.random_walk import random_walk, RandomWalkLoader
from gammagl_tpu_torch.loader.neighbor_sampler import (Adj,
                                                       NeighborSamplerLoader)
from gammagl_tpu_torch.loader.hetero_sampler import (HeteroNeighborSampler,
                                                     HeteroNeighborLoader)
from gammagl_tpu_torch.loader.prefetch import (PrefetchLoader,
                                               prefetch_to_device, pipeline)
from gammagl_tpu_torch.loader.epoch_cache import EpochCache
from gammagl_tpu_torch.loader.feature_cache import (DeviceFeatureCache,
                                                    ShardedFeatureStore)
from gammagl_tpu_torch.loader.multihost import (MultiHostNodeLoader,
                                                make_global_batch,
                                                pad_sampled_graph,
                                                shard_seeds)
from gammagl_tpu_torch.loader.rgt_loader import (ExtractLinkLoader,
                                                 ExtractNodeLoader,
                                                 build_structure_batch)

__all__ = [
    "DataLoader",
    "Collater",
    "NodeLoader",
    "NodeNeighborLoader",
    "filter_graph",
    "LinkLoader",
    "LinkNeighborLoader",
    "GraphSAINTSampler",
    "GraphSAINTNodeSampler",
    "GraphSAINTRandomWalkSampler",
    "random_walk",
    "RandomWalkLoader",
    "Adj",
    "NeighborSamplerLoader",
    "HeteroNeighborSampler",
    "HeteroNeighborLoader",
    "PrefetchLoader",
    "prefetch_to_device",
    "pipeline",
    "EpochCache",
    "DeviceFeatureCache",
    "ShardedFeatureStore",
    "MultiHostNodeLoader",
    "shard_seeds",
    "make_global_batch",
    "pad_sampled_graph",
    "ExtractNodeLoader",
    "ExtractLinkLoader",
    "build_structure_batch",
    "NeighborSampler",
    "RandomWalk",
]

# reference spellings (gammagl/loader/__init__.py)
NeighborSampler = NeighborSamplerLoader
RandomWalk = RandomWalkLoader
