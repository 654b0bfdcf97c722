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

It trains on IMDB read from the files under ``--dataset_path`` (the JAX
trainer's ``load``; staged files only, nothing is fetched) and, when they
are missing, on the JAX trainer's own synthetic movie/director graph,
which is `synthetic_hetero`'s (the same numpy stream), with the JAX
trainer's warning line.
"""

from gammagl_tpu_torch.examples.common import (base_parser, load_imdb,
                                               run_hetero_trainer,
                                               synthetic_hetero)
from gammagl_tpu_torch.models import HANModel
from gammagl_tpu_torch.utils import resolve_device

__all__ = ["load", "parser", "main"]


def load(args):
    """(HeteroGraph, target type): IMDB's staged files, else the
    synthetic typed graph, as the JAX trainer's ``load``."""
    try:
        return load_imdb(args)
    except Exception as e:
        print(f"[warn] IMDB unavailable ({e}); synthetic typed graph")
        return synthetic_hetero()


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                    lr=0.005, drop_rate=0.4)
    p.add_argument("--heads", type=int, default=4)
    return p


def main(args, data=None, params=None):
    """Train; returns what `run_hetero_trainer` returns. ``data`` is a
    (HeteroGraph, target type) pair (None: `load`); ``params`` an
    optional flax-shaped tree for `load_jax_params`."""
    resolve_device(args.device)

    def make(metadata, num_classes, target, in_channels):
        return HANModel(metadata, args.hidden_dim, num_classes, target,
                        heads=args.heads, drop_rate=args.drop_rate,
                        in_channels=in_channels)
    return run_hetero_trainer(make, args,
                              data=load(args) if data is None else data,
                              params=params)


if __name__ == "__main__":
    main(parser().parse_args())
