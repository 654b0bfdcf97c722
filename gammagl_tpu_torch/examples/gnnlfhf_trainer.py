"""GNN-LF/HF trainer: unified low- and high-pass propagation filters.

Twin of `examples/gnnlfhf/gnnlfhf_trainer.py`: the same model
(`GNNLFHFModel`, ``--hidden_dim``, ``--variant`` 'lf' or 'hf', K = 10
steps, dropout ``--drop_rate``), the same loop
(`examples.common.run_simple_node_trainer`) and the same flags, plus
``--device``. The propagation takes no plan, as in JAX: its 2K ('lf') or
K ('hf') products a forward are the port's COO `spmm`.

    python -m gammagl_tpu_torch.examples.gnnlfhf_trainer              # the card
    python -m gammagl_tpu_torch.examples.gnnlfhf_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GNNLFHFModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, variant="lf")


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GNNLFHFModel(hidden_dim=args.hidden_dim,
                         num_class=int(np.asarray(data["y"]).max()) + 1,
                         variant=args.variant, K=10,
                         drop_rate=args.drop_rate,
                         in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
