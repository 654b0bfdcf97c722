"""Node2Vec trainer: biased random walks (p, q), skip-gram and a linear
probe.

Twin of `examples/node2vec/node2vec_trainer.py`: the deepwalk twin's loop
(`deepwalk_trainer.main`) with a `Node2Vec` table of return parameter
``--p`` and in-out parameter ``--q``. The same flags, plus ``--device``.

    python -m gammagl_tpu_torch.examples.node2vec_trainer              # the card
    python -m gammagl_tpu_torch.examples.node2vec_trainer --device cpu
"""

from gammagl_tpu_torch.examples import deepwalk_trainer
from gammagl_tpu_torch.models import Node2Vec

__all__ = ["parser", "main"]


def parser():
    p = deepwalk_trainer.parser()
    p.description = __doc__.splitlines()[0]
    p.add_argument("--p", type=float, default=4.0)
    p.add_argument("--q", type=float, default=1.0)
    return p


def main(args, data=None, params=None):
    return deepwalk_trainer.main(args, model_cls=Node2Vec, data=data,
                                 params=params, p=args.p, q=args.q)


if __name__ == "__main__":
    main(parser().parse_args())
