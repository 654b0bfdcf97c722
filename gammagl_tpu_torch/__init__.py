"""gammagl_tpu_torch: the PyTorch and CUDA port of gammagl_tpu.

A second package beside the JAX one, with the same module paths, so each
part has its counterpart in `gammagl_tpu`. Plain tensor code is PyTorch;
each TPU kernel of the JAX package becomes a kernel written by hand for
NVIDIA Hopper, under ``csrc/`` and bound in `ops.cuda`. Kernels are built
at first use, never at import. This package imports neither JAX nor
`gammagl_tpu`.

Layer map:
  ops/        -- segment reductions, edge softmax, COO SpMM and SDDMM; the
                 kernels: CSR SpMM and per-edge segment sum, block-pair
                 SpMM, segment max and min, fused edge attention, HGT
                 attention, destination expand and SDDMM, with backwards
  data/       -- Graph (cached CSR and block-pair plans, node reorderings,
                 auto_plan), HeteroGraph
  parallel/   -- the node orderings (RCM, label propagation)
  layers/     -- MessagePassing, GCNConv, GATConv, GATV2Conv, SAGEConv,
                 HeteroConv, HGTConv
  models/     -- GCNModel, GATModel, GATV2Model, GraphSAGEModel,
                 GraphSAGESampleModel, HGTModel
  train/      -- loss, accuracy, the Adam train state and checkpoints
  utils/      -- self-loops, compute dtype, flax parameter loading, the
                 default device (the CUDA card)
  serve       -- InferenceSession
  examples/   -- trainer twins (python -m gammagl_tpu_torch.examples.<name>)
"""

__version__ = "0.1.0"

from gammagl_tpu_torch import ops  # noqa: F401
from gammagl_tpu_torch import utils  # noqa: F401
from gammagl_tpu_torch import data  # noqa: F401
from gammagl_tpu_torch import layers  # noqa: F401
from gammagl_tpu_torch import models  # noqa: F401
from gammagl_tpu_torch import train  # noqa: F401
from gammagl_tpu_torch import serve  # noqa: F401
