"""SGFormer trainer: a linear graph transformer with a GCN branch.

Twin of `examples/sgformer/sgformer_trainer.py`: the same model
(`SGFormerModel`, ``--hidden_dim``, one head, two GCN layers, graph weight
0.8, dropout ``--drop_rate``), the same loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy) and the same
flags, plus ``--device``. The GCN branch takes no plan, as in JAX: its
sums are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.sgformer_trainer              # the card
    python -m gammagl_tpu_torch.examples.sgformer_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import SGFormerModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = SGFormerModel(hidden_dim=args.hidden_dim,
                          num_class=int(np.asarray(data["y"]).max()) + 1,
                          drop_rate=args.drop_rate,
                          in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
