"""HAN trainer: HANModel on a typed graph through the flash attention
kernels.

Twin of `examples/han/han_trainer.py`: the same model (`HANModel`,
``--heads`` heads of ``--hidden_dim``, attention dropout ``--drop_rate``),
the same loop (`examples.common.run_hetero_trainer`: Adam on the target
type's masked cross-entropy, test accuracy in eval mode) and the same
flags, plus ``--device``. On the card each relation's GAT gets its
`CSRPlan` and runs the flash kernels forward and backward (the feature
gradient through the CSR SpMM); on the CPU the COO route runs in plain
PyTorch.

    python -m gammagl_tpu_torch.examples.han_trainer              # the card
    python -m gammagl_tpu_torch.examples.han_trainer --device cpu

It runs on the synthetic movie/director graph of the JAX trainer's
fallback, made from numpy. The JAX trainer's IMDB loader waits until the
port has ``datasets/`` and the files are in the tree; ``--dataset`` and
``--dataset_path`` are accepted and only name the run.
"""

from gammagl_tpu_torch.examples.common import base_parser, run_hetero_trainer
from gammagl_tpu_torch.models import HANModel

__all__ = ["parser", "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                    lr=0.005, drop_rate=0.4)
    p.add_argument("--heads", type=int, default=4)
    return p


def main(args, data=None, params=None):
    """Train; returns what `run_hetero_trainer` returns. ``data`` is a
    (HeteroGraph, target type) pair (None: the synthetic typed graph);
    ``params`` an optional flax-shaped tree for `load_jax_params`."""
    def make(metadata, num_classes, target, in_channels):
        return HANModel(metadata, args.hidden_dim, num_classes, target,
                        heads=args.heads, drop_rate=args.drop_rate,
                        in_channels=in_channels)
    return run_hetero_trainer(make, args, data=data, params=params)


if __name__ == "__main__":
    main(parser().parse_args())
