"""CoED trainer: directional convolutions mixing the forward and reverse
channels, with jumping knowledge.

Twin of `examples/coed/coed_trainer.py`: the same model (`CoEDModel`,
``--hidden_dim``, alpha 0.3, 'cat' jumping knowledge, the model's own
dropout 0.5), the same loop (`examples.common.run_simple_node_trainer`:
Adam with decayed weights on the masked cross-entropy, best-validation
test accuracy) and the same flags, plus ``--device``. The model takes no
plan, as in JAX: its sums are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.coed_trainer              # the card
    python -m gammagl_tpu_torch.examples.coed_trainer --device cpu
"""

import numpy as np

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import CoEDModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    model = CoEDModel(num_class=int(np.asarray(data["y"]).max()) + 1,
                      hidden_dim=args.hidden_dim, alpha=0.3,
                      jumping_knowledge="cat",
                      in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
