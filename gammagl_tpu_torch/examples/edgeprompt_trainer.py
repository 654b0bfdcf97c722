"""EdgePrompt trainer: learnable prompts added to an encoder's messages.

Twin of `examples/edgeprompt/edgeprompt_trainer.py`: the same network
(`Net`: an `EdgePromptModel` of ``--hidden_dim`` and 4 prompts, flax name
``EdgePromptModel_0``), the same loop
(`examples.common.run_simple_node_trainer`: Adam with decayed weights on
the masked cross-entropy, best-validation test accuracy; like the JAX
loop it trains the encoder too) and the same flags, plus ``--device``.
The model takes no plan, as in JAX: its sums are the port's COO ops on
every device.

    python -m gammagl_tpu_torch.examples.edgeprompt_trainer              # the card
    python -m gammagl_tpu_torch.examples.edgeprompt_trainer --device cpu
"""

import numpy as np
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import EdgePromptModel

__all__ = ["Net", "parser", "main"]


class Net(nn.Module):
    """The JAX trainer's network: one `EdgePromptModel`."""

    def __init__(self, hidden_dim=16, num_class=7, in_channels=None):
        super().__init__()
        self.model = EdgePromptModel(num_class, hidden_dim, num_prompts=4,
                                     in_channels=in_channels)

    def flax_tree(self):
        return {"EdgePromptModel_0": self.model}

    def forward(self, x, edge_index):
        return self.model(x, edge_index)


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16)


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    model = Net(hidden_dim=args.hidden_dim,
                num_class=int(np.asarray(data["y"]).max()) + 1,
                in_channels=np.asarray(data["x"]).shape[1])
    return run_simple_node_trainer(model, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
