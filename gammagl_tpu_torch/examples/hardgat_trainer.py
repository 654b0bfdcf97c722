"""HardGAT trainer: hard graph attention, each destination attending to
its top-k sources only.

Twin of `examples/hardgat/hardgat_trainer.py`: the same model
(`HardGATModel`, ``--hidden_dim`` 8 a head, 8 heads, k = 8), the same
loop (`examples.common.run_simple_node_trainer`: Adam with decayed
weights on the masked cross-entropy, best-validation test accuracy) and
the same flags, plus ``--device``. The model takes no plan, as in JAX:
its top-k peeling, softmax and sums are the port's COO ops on every
device.

    python -m gammagl_tpu_torch.examples.hardgat_trainer              # the card
    python -m gammagl_tpu_torch.examples.hardgat_trainer --device cpu
"""

import numpy as np

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import HardGATModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=8)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    model = HardGATModel(hidden_dim=args.hidden_dim,
                         num_class=int(np.asarray(data["y"]).max()) + 1,
                         heads=8, k=8,
                         in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
