"""GCNII trainer: GCNIIModel through the CSR SpMM kernel.

Twin of `examples/gcnii/gcnii_trainer.py`: the same model (`GCNIIModel`,
8 layers), the same loop (`examples.common.run_simple_node_trainer`:
Adam with decayed weights on the masked cross-entropy, best-validation
test accuracy) and the same flags, plus ``--device``. The model gets the
graph's `CSRPlan`, so on the card every hop and its gradient run the CSR
SpMM kernel; on the CPU its plain version.

    python -m gammagl_tpu_torch.examples.gcnii_trainer              # the card
    python -m gammagl_tpu_torch.examples.gcnii_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GCNIIModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GCNIIModel(hidden_dim=args.hidden_dim,
                       num_class=int(np.asarray(data["y"]).max()) + 1,
                       num_layers=8, drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
