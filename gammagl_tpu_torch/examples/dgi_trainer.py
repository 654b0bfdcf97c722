"""DGI trainer: Deep Graph Infomax pretraining, then a linear probe on the
frozen embeddings.

Twin of `examples/dgi/dgi_trainer.py`: the same model (`DGIModel`,
hidden ``--hidden_dim``), the same loop (`examples.common.
run_corruption_ssl`: each step a fresh row permutation of x as the
negatives and an Adam step at ``--lr``, in chunks of 20 steps, so
ceil(``--n_epoch`` / 20) x 20 steps in all, as the JAX script's scan
runs; then 300 Adam steps of the probe on the unit-normalised
embeddings) and the same flags, plus ``--device``. The encoder takes no
plan, as in JAX: its sums are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.dgi_trainer              # the card
    python -m gammagl_tpu_torch.examples.dgi_trainer --device cpu
"""

import math

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_corruption_ssl)
from gammagl_tpu_torch.models import DGIModel

__all__ = ["parser", "main", "CHUNK"]

CHUNK = 20  # steps a chunk (the JAX script's lax.scan length)


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=256, n_epoch=100,
                       lr=0.001)


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns what `run_corruption_ssl` returns.
    ``data``, ``params`` and ``draws`` (one permutation a step) as
    there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = DGIModel(hidden_dim=args.hidden_dim,
                     in_channels=np.asarray(data["x"]).shape[1])
    return run_corruption_ssl(model, args, data=data, params=params,
                              draws=draws, log_every=CHUNK,
                              n_steps=math.ceil(args.n_epoch / CHUNK) * CHUNK)


if __name__ == "__main__":
    main(parser().parse_args())
