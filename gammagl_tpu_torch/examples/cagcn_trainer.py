"""CAGCN trainer: confidence calibration by a two-layer GCN.

Twin of `examples/cagcn/cagcn_trainer.py`: the same model (`CAGCNModel`,
hidden ``--hidden_dim``), the same loop
(`examples.common.run_simple_node_trainer`) and the same flags, plus
``--device``. As in the JAX script the model calibrates its input: the
features pass as the logits, each row divided by its node's temperature,
and the masked cross-entropy reads that (N, features) output. The GCNs
take no plan, as in JAX.

    python -m gammagl_tpu_torch.examples.cagcn_trainer              # the card
    python -m gammagl_tpu_torch.examples.cagcn_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import CAGCNModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = CAGCNModel(num_class=int(np.asarray(data["y"]).max()) + 1,
                       hidden_dim=args.hidden_dim, drop_rate=args.drop_rate,
                       in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
