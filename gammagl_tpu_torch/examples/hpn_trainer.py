"""HPN trainer: HPNModel (APPNP on metapaths, semantic attention).

Twin of `examples/hpn/hpn_trainer.py`: the same model (`HPNModel`, 3
APPNP steps at alpha 0.1, ``--hidden_dim`` wide), the same loop
(`examples.common.run_hetero_trainer`: Adam on the target type's masked
cross-entropy, test accuracy in eval mode) and the same flags, plus
``--device``. Like the JAX model it takes no plan: its sums are COO on
every device. ``--drop_rate`` is accepted and unused, as in the JAX
trainer.

    python -m gammagl_tpu_torch.examples.hpn_trainer  # the card
    python -m gammagl_tpu_torch.examples.hpn_trainer --device cpu

It trains on IMDB read from the files under ``--dataset_path`` (the
JAX trainer's ``load_imdb``; staged files only, nothing is fetched) and,
when they are missing, on the synthetic movie/director graph of the JAX
trainer's fallback, made from numpy.
"""

from gammagl_tpu_torch.examples.common import (base_parser, load_imdb,
                                               run_hetero_trainer)
from gammagl_tpu_torch.models import HPNModel

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                       lr=0.005, drop_rate=0.4)


def main(args, data=None, params=None):
    """Train; returns what `run_hetero_trainer` returns. ``data`` is a
    (HeteroGraph, target type) pair (None: IMDB's staged files, else the
    synthetic typed graph);
    ``params`` an optional flax-shaped tree for `load_jax_params`."""
    def make(metadata, num_classes, target, in_channels):
        return HPNModel(metadata, args.hidden_dim, num_classes, target,
                        in_channels=in_channels)
    return run_hetero_trainer(make, args, data=data, params=params,
                              dataset_loader=load_imdb)


if __name__ == "__main__":
    main(parser().parse_args())
