"""MVGRL trainer: adjacency view against diffusion view, then a linear
probe on the frozen embeddings.

Twin of `examples/mvgrl/mvgrl_trainer.py`: the same model (`MVGRLModel`,
hidden ``--hidden_dim``), the same diffusion view (the JAX script's: the
self-looped edges weighted by `calc_gcn_norm`, standing in for PPR), the
same loop (`examples.common.run_corruption_ssl`: a fresh row permutation
each step, Adam at ``--lr``, ``--n_epoch`` steps, then `linear_probe` on
the sum of the two views' embeddings) and the same flags, plus
``--device``. The encoders take no plan, as in JAX: their sums are the
port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.mvgrl_trainer              # the card
    python -m gammagl_tpu_torch.examples.mvgrl_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_corruption_ssl)
from gammagl_tpu_torch.models import MVGRLModel
from gammagl_tpu_torch.utils import calc_gcn_norm

__all__ = ["parser", "main", "diffusion_view"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=128, n_epoch=50,
                       lr=0.001)


def diffusion_view(d):
    """The diffusion view's (edges, weights): the self-looped edges and
    their symmetric GCN norm."""
    ei = d["edge_index"]
    return ei, calc_gcn_norm(ei, d["x"].shape[0])


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns what `run_corruption_ssl` returns.
    ``data``, ``params`` and ``draws`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = MVGRLModel(hidden_dim=args.hidden_dim,
                       in_channels=np.asarray(data["x"]).shape[1])
    return run_corruption_ssl(model, args, views=diffusion_view, data=data,
                              params=params, draws=draws)


if __name__ == "__main__":
    main(parser().parse_args())
