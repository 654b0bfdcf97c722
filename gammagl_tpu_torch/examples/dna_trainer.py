"""DNA trainer: a DNAConv net (dynamic neighbourhood aggregation).

Twin of `examples/dna/dna_trainer.py`: the same model (its ``Net``,
built inline from the conv as the JAX script builds it), the same loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy) and the same
flags, plus ``--device``. Like the JAX conv it takes no plan: its sums
are the port's COO ops on every device. Dropout draws from the loop's
generator.

    python -m gammagl_tpu_torch.examples.dna_trainer              # the card
    python -m gammagl_tpu_torch.examples.dna_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.layers.conv import DNAConv
from gammagl_tpu_torch.layers.dense import (dropout, lecun_apply,
                                            lecun_dense)

__all__ = ["Net", "parser", "main"]


class Net(nn.Module):
    """The JAX trainer's ``Net``: dropout, a map to ``hidden_dim`` (flax
    ``Dense_0``) and ReLU; two one-head DNAConvs (``DNAConv_0``,
    ``DNAConv_1``), each attending over the stack of the representations
    so far and adding its output to the stack; dropout of the last
    representation and a map to ``num_class`` (``Dense_1``)."""

    def __init__(self, hidden_dim=16, num_class=7, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin_in = lecun_dense(in_channels, hidden_dim)
        self.convs = nn.ModuleList(DNAConv(hidden_dim, heads=1)
                                   for _ in range(2))
        self.lin_out = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"Dense_0": self.lin_in, "DNAConv_0": self.convs[0],
                "DNAConv_1": self.convs[1], "Dense_1": self.lin_out}

    def forward(self, x, edge_index, generator=None):
        rate = self.drop_rate if self.training else 0.0
        h = F.relu(lecun_apply(self.lin_in, dropout(x, rate, generator)))
        hs = h[:, None]
        for conv in self.convs:
            h = conv(hs, edge_index)
            hs = torch.cat([hs, h[:, None]], dim=1)
        return lecun_apply(self.lin_out, dropout(hs[:, -1], rate, generator))


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
