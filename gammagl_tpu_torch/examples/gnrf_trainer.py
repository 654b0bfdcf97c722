"""GNRF trainer: a graph neural ODE (a learned repulsion field)
integrated by RK4.

Twin of `examples/gnrf/gnrf_trainer.py`: the same model (`GNRFModel`,
``--hidden_dim``, 8 RK4 steps, the model's own dropout 0.2), the same
loop (`examples.common.run_simple_node_trainer`: Adam with decayed
weights on the masked cross-entropy, best-validation test accuracy) and
the same flags, plus ``--device``. The model takes no plan, as in JAX:
the field's sums and means are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.gnrf_trainer              # the card
    python -m gammagl_tpu_torch.examples.gnrf_trainer --device cpu
"""

import numpy as np

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GNRFModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    model = GNRFModel(num_class=int(np.asarray(data["y"]).max()) + 1,
                      hidden=args.hidden_dim, num_steps=8,
                      in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
