"""GIN trainer: GINModel on a node task, as the JAX trainer runs it.

Twin of `examples/gin/gin_trainer.py`: the same model (`GINModel`, 2
layers), the same loop (`examples.common.run_simple_node_trainer`: Adam
with decayed weights on the masked cross-entropy, best-validation test
accuracy) and the same flags, plus ``--device``. GINModel is a graph
readout: with no batch vector it pools the whole graph into one row of
logits, which the loss gives every node (ROADMAP C17 and C18). It takes
no plan, as in JAX: its sums are COO.

    python -m gammagl_tpu_torch.examples.gin_trainer  # the card
    python -m gammagl_tpu_torch.examples.gin_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GINModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GINModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     num_layers=2, drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
