"""DropEdge trainer: a 2-layer GCN that drops half its edges each
training step.

Twin of `examples/dropedge/dropedge_trainer.py`: the same network
(`Net`: GCNConv, ReLU, dropout, GCNConv, flax ``GCNConv_0``/``_1``; in
training mode each edge is kept with probability 0.5 and a dropped one
is routed out of range, which the sums drop exactly), the same loop
(`common.run_simple_node_trainer`: Adam with decayed weights on the masked
cross-entropy, best-validation test accuracy) and flags, plus
``--device``. The edge mask is drawn from the loop's generator, or taken
from ``keep`` (E,) bools. COO on every device, as in JAX.

    python -m gammagl_tpu_torch.examples.dropedge_trainer              # the card
    python -m gammagl_tpu_torch.examples.dropedge_trainer --device cpu
"""

import numpy as np
import torch
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.dense import dropout

__all__ = ["Net", "parser", "main"]


class Net(nn.Module):
    def __init__(self, hidden_dim=16, num_class=7, drop_rate=0.5):
        super().__init__()
        self.conv1 = GCNConv(None, hidden_dim)
        self.conv2 = GCNConv(hidden_dim, num_class)
        self.drop_rate = drop_rate

    def flax_tree(self):
        return {"GCNConv_0": self.conv1, "GCNConv_1": self.conv2}

    def forward(self, x, edge_index, generator=None, keep=None):
        n = x.shape[0]
        if self.training:
            if keep is None:
                dev = generator.device if generator is not None else x.device
                keep = torch.rand(edge_index.shape[1], generator=generator,
                                  device=dev) < 0.5
            edge_index = torch.where(keep.to(x.device)[None], edge_index,
                                     n + 1)
            h = torch.relu(self.conv1(x, edge_index, num_nodes=n))
            h = dropout(h, self.drop_rate, generator)
        else:
            h = torch.relu(self.conv1(x, edge_index, num_nodes=n))
        return self.conv2(h, edge_index, num_nodes=n)


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None, forward_kwargs=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data``,
    ``params`` and ``forward_kwargs`` (a fixed ``keep``) as there."""
    data = node_data(args, data)
    model = Net(hidden_dim=args.hidden_dim,
                num_class=int(np.asarray(data["y"]).max()) + 1,
                drop_rate=args.drop_rate)
    return run_simple_node_trainer(model, args, data=data, params=params,
                                   forward_kwargs=forward_kwargs)


if __name__ == "__main__":
    main(parser().parse_args())
