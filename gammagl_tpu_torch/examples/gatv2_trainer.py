"""GATv2 trainer: GATV2Model through the edge-endpoint and flash kernels.

Twin of `examples/gatv2/gatv2_trainer.py`: the same model (two GATV2Convs,
8 heads, input and attention dropout at ``--drop_rate``), the same
full-batch loop (`examples.common.run_simple_node_trainer`: Adam with
decayed weights on the masked cross-entropy, best-validation test
accuracy) and the same flags, plus ``--device``. On the card each layer
runs the expand kernel forward and the per-edge segment sum backward for
the destination side, the flash kernels for softmax and sum, and the SpMM
kernel for the source side's gradient; on the CPU the same calls run
their plain versions.

    python -m gammagl_tpu_torch.examples.gatv2_trainer              # the card
    python -m gammagl_tpu_torch.examples.gatv2_trainer --device cpu

The graph is the JAX trainer's: `load_node_dataset` of ``--dataset``
under ``--dataset_path``, or the arrays given to `main`.
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GATV2Model

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=8)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there (None: `load_node_dataset`'s graph and a fresh
    init)."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GATV2Model(hidden_dim=args.hidden_dim,
                       num_class=int(np.asarray(data["y"]).max()) + 1,
                       heads=8, drop_rate=args.drop_rate,
                       in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
