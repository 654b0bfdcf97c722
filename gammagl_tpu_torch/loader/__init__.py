"""Loaders (counterpart of `gammagl_tpu/loader/`; reference:
gammagl/loader/).

Ported: the graph DataLoader, the node, link and layered neighbour
loaders over the C++ sampler, GraphSAINT, random walks, the typed-graph
sampler, the epoch cache, the feature table on the card and prefetching
onto it. Not yet: the RGT loaders (`rgt_loader.py`), the multi-host loader
(`multihost.py`) and `ShardedFeatureStore`, which shard over a device
mesh.
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
from gammagl_tpu_torch.loader.feature_cache import DeviceFeatureCache

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
    "NeighborSampler",
    "RandomWalk",
]

# reference spellings (gammagl/loader/__init__.py)
NeighborSampler = NeighborSamplerLoader
RandomWalk = RandomWalkLoader
