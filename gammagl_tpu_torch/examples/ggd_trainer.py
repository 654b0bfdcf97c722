"""GGD trainer: Graph Group Discrimination pretraining, then a linear
probe on the frozen embeddings.

Twin of `examples/ggd/ggd_trainer.py`: the same model (`GGDModel`, hidden
``--hidden_dim``), the same loop (`examples.common.run_corruption_ssl`:
each step a fresh row permutation of x as the corrupted group and an Adam
step at ``--lr``, ``--n_epoch`` steps, then `linear_probe`) and the same
flags, plus ``--device``. The encoder takes no plan, as in JAX: its sums
are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.ggd_trainer              # the card
    python -m gammagl_tpu_torch.examples.ggd_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_corruption_ssl)
from gammagl_tpu_torch.models import GGDModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=128, n_epoch=50,
                       lr=0.001)


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns what `run_corruption_ssl` returns.
    ``data``, ``params`` and ``draws`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GGDModel(hidden_dim=args.hidden_dim,
                     in_channels=np.asarray(data["x"]).shape[1])
    return run_corruption_ssl(model, args, data=data, params=params,
                              draws=draws)


if __name__ == "__main__":
    main(parser().parse_args())
