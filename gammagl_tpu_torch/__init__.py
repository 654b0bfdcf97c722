"""gammagl_tpu_torch: the PyTorch and CUDA port of gammagl_tpu.

A second package beside the JAX one, with the same module paths, so each
part has its counterpart in `gammagl_tpu`. Plain tensor code is PyTorch;
each TPU kernel of the JAX package becomes a kernel written by hand for
NVIDIA Hopper, under ``csrc/`` and bound in `ops.cuda`. Kernels are built
at first use, never at import. This package imports neither JAX nor
`gammagl_tpu`.

Layer map:
  ops/        -- segment reductions (and their unsorted aliases), edge
                 softmax, COO SpMM and SDDMM, sparse-format conversions;
                 the kernels: CSR SpMM and per-edge segment sum,
                 block-pair SpMM, segment max and min, fused edge
                 attention, HGT attention, destination expand and SDDMM,
                 with backwards, and the CSR-order softmax and multi-head
                 SpMM built on them
  sparse/     -- SparseGraph, CSRAdj: host adjacency with cached formats
  csrc/       -- the CUDA sources of the kernels, and the host neighbour
                 sampler (sampler.cpp, built by g++ with OpenMP at first
                 use and bound by ctypes in csrc/__init__.py)
  sampler/    -- NeighborSampler (C++ or numpy route), padded samples
  loader/     -- the graph DataLoader, the neighbour, node, link, SAINT,
                 random-walk and typed-graph loaders, EpochCache, the
                 feature table on the card (DeviceFeatureCache) and
                 prefetching onto it (PrefetchLoader)
  data/       -- Graph (cached CSR and block-pair plans, node reorderings,
                 auto_plan, the mapping and batching protocols), HeteroGraph,
                 BatchGraph, padding, the dataset lifecycle (Dataset,
                 InMemoryDataset, downloads, config), EdgeIndex and the
                 feature and graph stores
  io/         -- raw-file readers: Planetoid, TU, npz, text arrays
  datasets/   -- Planetoid, OgbNodeDataset, TUDataset, the npz datasets,
                 the typed-graph datasets, Reddit, the synthetic graphs,
                 real-structure adjacencies
  parallel/   -- node orderings (RCM, label propagation, degree balance),
                 halo partitions and their SpMM tiers over
                 torch.distributed (flat and planned), full-graph GCN
                 training on them
  layers/     -- MessagePassing, GCNConv, GATConv, GATV2Conv, SAGEConv,
                 RGCNConv, HeteroConv, HANConv, HGTConv, SimpleHGNConv
  models/     -- GCNModel, GATModel, GATV2Model, GraphSAGEModel,
                 GraphSAGESampleModel, RGCNModel, HANModel, HGTModel,
                 SimpleHGNModel
  train/      -- loss, accuracy, micro and macro F1, the Adam train state
                 and checkpoints
  utils/      -- self-loops, GCN norm, degree, masks, coalesce,
                 undirected edges, subgraphs, compute dtype, flax parameter
                 loading, the default device (the CUDA card) and host
                 arrays to it
  serve       -- InferenceSession, MicroBatcher
  examples/   -- trainer twins (python -m gammagl_tpu_torch.examples.<name>),
                 the serving demo and the sampler benchmark, and their
                 dataset loader
"""

__version__ = "0.1.0"

from gammagl_tpu_torch import ops  # noqa: F401
from gammagl_tpu_torch import utils  # noqa: F401
from gammagl_tpu_torch import data  # noqa: F401
from gammagl_tpu_torch import layers  # noqa: F401
from gammagl_tpu_torch import models  # noqa: F401
from gammagl_tpu_torch import train  # noqa: F401
from gammagl_tpu_torch import serve  # noqa: F401
from gammagl_tpu_torch import sparse  # noqa: F401
