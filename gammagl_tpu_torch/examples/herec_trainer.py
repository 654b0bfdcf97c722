"""HERec trainer: metapath-graph walks, skip-gram, and fused embeddings
under a linear probe.

Twin of `examples/herec/herec_trainer.py`: on the JAX package's synthetic
movie/director graph, a `Node2Vec` table of ``--hidden_dim`` (walks of 5
steps) on the movie-director-movie graph, trained by the deepwalk twin's
loop (`deepwalk_trainer.train_walks`: batches of 128, the loader seeded
``--seed``, Adam at 0.01, ``--n_epoch`` epochs); `herec` fuses the
metapath embeddings (each, and their mean, concatenated) and
`common.linear_probe` scores the movies. The same flags, plus
``--device``.

    python -m gammagl_tpu_torch.examples.herec_trainer              # the card
    python -m gammagl_tpu_torch.examples.herec_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, linear_probe,
                                               synthetic_hetero)
from gammagl_tpu_torch.examples.deepwalk_trainer import train_walks
from gammagl_tpu_torch.models import Node2Vec, herec
from gammagl_tpu_torch.utils import resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=3)


def main(args, params=None):
    """Train, fuse and probe; returns {"losses" (the metapath table's
    steps), "probe_acc", "fused"}. ``params``: a flax tree of the table
    (None: its own init)."""
    dev = resolve_device(args.device)
    hg, _ = synthetic_hetero()
    n = hg["movie"].x.shape[0]
    torch.manual_seed(args.seed)
    model = Node2Vec(num_nodes=n, embedding_dim=args.hidden_dim,
                     walk_length=5)
    loader = model.make_loader(
        np.asarray(hg[("movie", "mdm", "movie")].edge_index),
        batch_size=128, seed=args.seed)
    losses, _ = train_walks(model, loader, args.n_epoch, 0.01, dev, params,
                            log=False)
    fused = herec([model().detach()])
    print("HERec fused embeddings:", fused.shape)
    y = np.asarray(hg["movie"].y)
    d = {"y": torch.from_numpy(y).to(dev),
         "train_mask": torch.from_numpy(
             np.asarray(hg["movie"].train_mask)).to(dev),
         "test_mask": torch.from_numpy(
             np.asarray(hg["movie"].test_mask)).to(dev)}
    acc = linear_probe(torch.from_numpy(fused).to(dev), d, int(y.max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": losses, "probe_acc": acc, "fused": fused}


if __name__ == "__main__":
    main(parser().parse_args())
