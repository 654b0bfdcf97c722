"""HCHA trainer: a two-layer HypergraphConv net on the star expansion.

Twin of `examples/hcha/hcha_trainer.py`: the same model (its ``Net``,
built inline from the conv as the JAX script builds it), the same loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy) and the same
flags, plus ``--device``. Like the JAX conv it takes no plan: its sums
are the port's COO ops on every device. Dropout draws from the loop's
generator.

    python -m gammagl_tpu_torch.examples.hcha_trainer              # the card
    python -m gammagl_tpu_torch.examples.hcha_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.layers.conv import HypergraphConv
from gammagl_tpu_torch.layers.dense import dropout

__all__ = ["Net", "parser", "main"]


class Net(nn.Module):
    """The JAX trainer's ``Net`` on the star expansion: hyperedge j is
    node j's neighbourhood, so the incidence pairs are the graph's edges
    and there are as many hyperedges as nodes. HypergraphConv to
    ``hidden_dim`` (flax ``HypergraphConv_0``), ReLU, dropout,
    HypergraphConv to ``num_class`` (``HypergraphConv_1``)."""

    def __init__(self, hidden_dim=16, num_class=7, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList([HypergraphConv(in_channels, hidden_dim),
                                    HypergraphConv(hidden_dim, num_class)])

    def flax_tree(self):
        return {f"HypergraphConv_{i}": conv
                for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, generator=None):
        n = x.shape[0]
        x = F.relu(self.convs[0](x, edge_index, num_nodes=n, num_edges=n))
        x = dropout(x, self.drop_rate if self.training else 0.0, generator)
        return self.convs[1](x, edge_index, num_nodes=n, num_edges=n)


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
