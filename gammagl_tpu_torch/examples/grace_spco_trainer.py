"""GRACE-Spco trainer: GRACE over edge-weighted views, then a linear
probe on the frozen embeddings.

Twin of `examples/grace_spco/grace_spco_trainer.py`: the same model
(`GraceSpcoModel`, ``--hidden_dim`` for the encoder and the projection),
the same loop (Adam at ``--lr``; each step two views by
`drop_edge_and_feature` at rates (0.2, 0.2) and (0.3, 0.3), the edge
masks the weights), the embeddings under unit weights, the same probe
and the same flags, plus ``--device``. The views' masks are drawn from a
generator on the device seeded ``--seed`` + 1, or handed in
(``draws``). The encoder takes no plan, as in JAX: its sums are the
port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.grace_spco_trainer              # the card
    python -m gammagl_tpu_torch.examples.grace_spco_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_two_view_ssl)
from gammagl_tpu_torch.models import GraceSpcoModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=50,
                       lr=0.001)


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns what `run_two_view_ssl` returns.
    ``data``, ``params`` and ``draws`` as there."""
    data = node_data(args, data)
    model = GraceSpcoModel(num_hidden=args.hidden_dim,
                           num_proj_hidden=args.hidden_dim,
                           in_channels=np.asarray(data["x"]).shape[1])
    return run_two_view_ssl(
        model, args, drop_rates=(0.2, 0.2, 0.3, 0.3),
        embed_fn=lambda m, x, ei: m(x, ei, torch.ones(ei.shape[1],
                                                      device=x.device)),
        data=data, params=params, draws=draws)


if __name__ == "__main__":
    main(parser().parse_args())
