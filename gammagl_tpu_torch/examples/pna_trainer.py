"""PNA trainer: PNAModel (principal neighbourhood aggregation).

Twin of `examples/pna/pna_trainer.py`: the same model (`PNAModel`, hidden ``--hidden_dim``, dropout ``--drop_rate``),
the same loop (`examples.common.run_simple_node_trainer`: Adam with
decayed weights on the masked cross-entropy, best-validation test
accuracy) and the same flags, plus ``--device``. Like the JAX model it
takes no plan: its sums are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.pna_trainer              # the card
    python -m gammagl_tpu_torch.examples.pna_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import PNAModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    num_class = int(np.asarray(data["y"]).max()) + 1
    torch.manual_seed(args.seed)
    model = PNAModel(hidden_dim=args.hidden_dim, num_class=num_class,
                     drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
