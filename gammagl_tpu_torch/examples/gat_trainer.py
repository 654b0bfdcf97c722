"""GAT trainer: GATModel through the flash attention kernels.

Twin of `examples/gat/gat_trainer.py`: the same model (two GATConvs,
``--heads`` heads of ``--hidden_dim``, input and attention dropout at
``--drop_rate``), the same full-batch loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy) and the same
flags, plus ``--device``. The model gets the graph's `CSRPlan`: on the
card every layer runs the flash kernels forward and backward and the
feature gradient the CSR SpMM; on the CPU the same calls run their plain
versions.

    python -m gammagl_tpu_torch.examples.gat_trainer              # the card
    python -m gammagl_tpu_torch.examples.gat_trainer --device cpu

The graph is the JAX trainer's: `load_node_dataset` of ``--dataset``
under ``--dataset_path`` (Planetoid's raw files, else the synthetic
community graph), or the arrays given to `main`.
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GATModel

__all__ = ["parser", "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=8, drop_rate=0.6)
    p.add_argument("--heads", type=int, default=8)
    return p


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there (None: `load_node_dataset`'s graph and a fresh
    init)."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GATModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     heads=args.heads, drop_rate=args.drop_rate,
                     in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
