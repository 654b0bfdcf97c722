"""FAGCN trainer: FAGCNModel through the CSR SpMM and SDDMM kernels.

Twin of `examples/fagcn/fagcn_trainer.py`: the same model (`FAGCNModel`,
2 layers), the same loop (`examples.common.run_simple_node_trainer`:
Adam with decayed weights on the masked cross-entropy, best-validation
test accuracy) and the same flags, plus ``--device``. The model gets the
graph's `CSRPlan`, so on the card every hop runs the CSR SpMM kernel,
and the gradient of its gates the SDDMM kernel; on the CPU their plain
versions.

    python -m gammagl_tpu_torch.examples.fagcn_trainer              # the card
    python -m gammagl_tpu_torch.examples.fagcn_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import FAGCNModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = FAGCNModel(hidden_dim=args.hidden_dim,
                       num_class=int(np.asarray(data["y"]).max()) + 1,
                       drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
