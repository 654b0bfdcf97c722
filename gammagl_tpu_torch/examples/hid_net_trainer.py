"""HiD-Net trainer: HiDNetModel's diffusion on the COO route.

Twin of `examples/hid_net/hid_net_trainer.py`: the same model
(`HiDNetModel`, 3 layers), the same loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy) and the same
flags, plus ``--device``. HidConv takes no plan, as in JAX: its sums are
COO.

    python -m gammagl_tpu_torch.examples.hid_net_trainer  # the card
    python -m gammagl_tpu_torch.examples.hid_net_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import HiDNetModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = HiDNetModel(hidden_dim=args.hidden_dim,
                        num_class=int(np.asarray(data["y"]).max()) + 1,
                        num_layers=3, drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
