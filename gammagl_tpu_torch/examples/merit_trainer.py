"""MERIT trainer: two-view siamese pretraining (a BYOL-style loss), then
a linear probe on the frozen embeddings.

Twin of `examples/merit/merit_trainer.py`: the same model (`Net`, which
wraps `MERITModel` at ``--hidden_dim`` into a loss: the mean of both
views' `byol_loss` against the other view), the same loop
(`examples.common.run_two_view_ssl`, Adam at ``--lr``; the embeddings
are the first view's predictions) and the same flags (the four
``--drop_*_rate_*``), plus ``--device``. As in JAX the target view is not
detached (the script's ``jnp.asarray(z2)`` stops no gradient), and the
loop hands the edge rate to the feature mask (ROADMAP C27). The encoder
takes no plan, as in JAX.

    python -m gammagl_tpu_torch.examples.merit_trainer              # the card
    python -m gammagl_tpu_torch.examples.merit_trainer --device cpu
"""

import numpy as np
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_two_view_ssl)
from gammagl_tpu_torch.models import MERITModel

__all__ = ["parser", "main", "Net"]


class Net(nn.Module):
    """MERIT's (z1, z2) forward as a loss (flax ``MERITModel_0``); with one
    view, its prediction."""

    def __init__(self, hidden_dim=128, in_channels=None):
        super().__init__()
        self.merit = MERITModel(hidden_dim=hidden_dim,
                                in_channels=in_channels)

    def flax_tree(self):
        return {"MERITModel_0": self.merit}

    def forward(self, x1, ei1, w1, x2=None, ei2=None, w2=None):
        if x2 is None:
            return self.merit(x1, ei1, w1, x1, ei1, w1)[0]
        z1, z2 = self.merit(x1, ei1, w1, x2, ei2, w2)
        return 0.5 * (MERITModel.byol_loss(z1, z2)
                      + MERITModel.byol_loss(z2, z1))


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=128, n_epoch=100,
                    lr=0.0005)
    p.add_argument("--drop_edge_rate_1", type=float, default=0.2)
    p.add_argument("--drop_feature_rate_1", type=float, default=0.5)
    p.add_argument("--drop_edge_rate_2", type=float, default=0.2)
    p.add_argument("--drop_feature_rate_2", type=float, default=0.5)
    return p


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns what `run_two_view_ssl` returns.
    ``data``, ``params`` and ``draws`` as there."""
    data = node_data(args, data)
    model = Net(hidden_dim=args.hidden_dim,
                in_channels=np.asarray(data["x"]).shape[1])
    return run_two_view_ssl(model, args, drop_rates=(0.2, 0.5, 0.2, 0.5),
                            embed_fn=lambda m, x, ei: m(x, ei, None),
                            data=data, params=params, draws=draws)


if __name__ == "__main__":
    main(parser().parse_args())
