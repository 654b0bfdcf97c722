"""MGNNI trainer: MGNNIModel (multiscale implicit GNN, a damped
fixed-point iteration at scales 1 and 2, 8 iterations each).

Twin of `examples/mgnni/mgnni_trainer.py`: the same model (`MGNNIModel`,
hidden ``--hidden_dim``, ``scales=(1, 2)``, ``iters=8``), the same loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy) and the same
flags, plus ``--device``. Like the JAX model it takes no plan: its
iterations are the port's COO `spmm` on every device.

    python -m gammagl_tpu_torch.examples.mgnni_trainer              # the card
    python -m gammagl_tpu_torch.examples.mgnni_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import MGNNIModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    num_class = int(np.asarray(data["y"]).max()) + 1
    torch.manual_seed(args.seed)
    model = MGNNIModel(num_class=num_class, hidden_dim=args.hidden_dim,
                       scales=(1, 2), iters=8,
                       in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
