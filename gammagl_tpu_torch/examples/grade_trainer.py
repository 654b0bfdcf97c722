"""GRADE trainer: two-view contrastive pretraining (NT-Xent), then a
linear probe on the frozen embeddings.

Twin of `examples/grade/grade_trainer.py`: the same model (`GRADEModel`,
``--hidden_dim``, tau 0.5), the same loop
(`examples.common.run_two_view_ssl`, Adam at ``--lr``) and the same flags
(the four ``--drop_*_rate_*``), plus ``--device``. Like the JAX loop it
hands the edge rate to the feature mask (ROADMAP C27); its loss is the
port's `grace_loss`, finite where a node loses every in-edge (C28). The
encoder takes no plan, as in JAX.

    python -m gammagl_tpu_torch.examples.grade_trainer              # the card
    python -m gammagl_tpu_torch.examples.grade_trainer --device cpu
"""

import numpy as np

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_two_view_ssl)
from gammagl_tpu_torch.models import GRADEModel

__all__ = ["parser", "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=128, n_epoch=100,
                    lr=0.0005)
    p.add_argument("--drop_edge_rate_1", type=float, default=0.2)
    p.add_argument("--drop_feature_rate_1", type=float, default=0.2)
    p.add_argument("--drop_edge_rate_2", type=float, default=0.2)
    p.add_argument("--drop_feature_rate_2", type=float, default=0.2)
    return p


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns what `run_two_view_ssl` returns.
    ``data``, ``params`` and ``draws`` as there."""
    data = node_data(args, data)
    model = GRADEModel(hidden_dim=args.hidden_dim,
                       in_channels=np.asarray(data["x"]).shape[1])
    return run_two_view_ssl(model, args, drop_rates=(0.2, 0.2, 0.2, 0.2),
                            embed_fn=lambda m, x, ei: m(x, ei, None),
                            data=data, params=params, draws=draws)


if __name__ == "__main__":
    main(parser().parse_args())
