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

It runs on the JAX trainer's fallback graph, the synthetic community
graph (1000 nodes, 7 classes) made from ``--seed``; the Planetoid loader
waits until the port has ``datasets/``, and ``--dataset`` only names the
run.
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser,
                                               run_simple_node_trainer,
                                               synthetic_community_graph)
from gammagl_tpu_torch.models import GATModel

__all__ = ["parser", "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=8, drop_rate=0.6)
    p.add_argument("--heads", type=int, default=8)
    return p


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there (None: the synthetic graph from ``args.seed`` and
    a fresh init)."""
    if data is None:
        data = synthetic_community_graph(seed=args.seed)
    torch.manual_seed(args.seed)
    model = GATModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     heads=args.heads, drop_rate=args.drop_rate,
                     in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
