"""HGT trainer: HGTModel on a typed graph through the HGT kernels.

Twin of `examples/hgt/hgt_trainer.py`: the same model (`HGTModel`, 2 heads,
``--hidden_dim`` wide, attention dropout 0.2 inside each HGTConv), the
same loop (`examples.common.run_hetero_trainer`: Adam on the target type's
masked cross-entropy, test accuracy in eval mode) and the same flags, plus
``--device``. On the card each relation gets its `CSRPlan`: eval forwards
with bf16 compute (the process default of `utils.compute_dtype`) and
H*D % 128 == 0 take the fused HGT attention kernels, training with dropout
the decomposed route (the expand, flash and SpMM kernels); on the CPU the
COO route runs in plain PyTorch.

    python -m gammagl_tpu_torch.examples.hgt_trainer              # the card
    python -m gammagl_tpu_torch.examples.hgt_trainer --device cpu

It trains on IMDB read from the files under ``--dataset_path`` (the
JAX trainer's ``load_imdb``; staged files only, nothing is fetched) and,
when they are missing, on the synthetic movie/director graph of the JAX
trainer's fallback, made from numpy.
"""

from gammagl_tpu_torch.examples.common import (base_parser, load_imdb,
                                               run_hetero_trainer)
from gammagl_tpu_torch.models import HGTModel

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
        return HGTModel(metadata, args.hidden_dim, num_classes, target,
                        heads=2, in_channels=in_channels)
    return run_hetero_trainer(make, args, data=data, params=params,
                              dataset_loader=load_imdb)


if __name__ == "__main__":
    main(parser().parse_args())
