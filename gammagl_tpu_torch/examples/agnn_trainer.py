"""AGNN trainer: two AGNNConvs between two maps, assembled here.

Twin of `examples/agnn/agnn_trainer.py`: the same network (`Net`: dropout,
a ReLU map to ``--hidden_dim``, two `AGNNConv`s, dropout, a map to the
classes), the same loop (`examples.common.run_simple_node_trainer`: Adam
with decayed weights on the masked cross-entropy, best-validation test
accuracy) and the same flags, plus ``--device``. The network takes no
plan, as the JAX trainer's does not, so its sums are COO; `AGNNConv`
itself takes one (the CSR SpMM kernel, and the SDDMM for its attention's
gradient).

    python -m gammagl_tpu_torch.examples.agnn_trainer  # the card
    python -m gammagl_tpu_torch.examples.agnn_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.layers.conv import AGNNConv
from gammagl_tpu_torch.layers.dense import (dense, dropout, lecun_dense,
                                            lecun_normal_)

__all__ = ["Net", "parser", "main"]


class Net(nn.Module):
    """The JAX trainer's network (flax names ``Dense_0``, ``AGNNConv_0``,
    ``AGNNConv_1``, ``Dense_1``); dropout in training mode draws from
    ``generator``. ``in_channels=None`` leaves the first map lazy."""

    def __init__(self, hidden_dim=16, num_class=7, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.convs = nn.ModuleList(AGNNConv() for _ in range(2))
        self.lin1 = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "AGNNConv_0": self.convs[0],
                "AGNNConv_1": self.convs[1], "Dense_1": self.lin1}

    def forward(self, x, edge_index, generator=None):
        return self.run(x, edge_index, generator)

    def run(self, x, edge_index, generator=None, plan=None):
        """The forward, with ``plan`` handed to both AGNNConvs."""
        rate = self.drop_rate if self.training else 0.0
        x = F.relu(dense(self.lin0, dropout(x, rate, generator), None,
                         lecun_normal_))
        for conv in self.convs:
            x = conv(x, edge_index, plan=plan)
        return dense(self.lin1, dropout(x, rate, generator), None,
                     lecun_normal_)


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = Net(hidden_dim=args.hidden_dim,
                num_class=int(np.asarray(data["y"]).max()) + 1,
                drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
