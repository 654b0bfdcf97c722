"""MetaPath2Vec trainer: walks along a metapath, skip-gram and a linear
probe of the movies.

Twin of `examples/metapath2vec/metapath2vec_trainer.py`: on the JAX
package's synthetic movie/director graph (`common.synthetic_hetero`), a
`MetaPath2Vec` table of ``--hidden_dim`` (walks of 4 steps along movie ->
director -> movie); each epoch 128 start movies, their walks
(`MetaPath2Vec.sample_walks`) and one negative walk each, all from
``np.random.default_rng(--seed)`` in the JAX script's order, and one
Adam step at ``--lr``; then `common.linear_probe` on the movie rows. The
same flags, plus ``--device``.

    python -m gammagl_tpu_torch.examples.metapath2vec_trainer              # the card
    python -m gammagl_tpu_torch.examples.metapath2vec_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, linear_probe,
                                               synthetic_hetero)
from gammagl_tpu_torch.models import MetaPath2Vec
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "METAPATH"]

METAPATH = (("movie", "by", "director"), ("director", "directs", "movie"))


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=5,
                       lr=0.01)


def main(args, params=None):
    """Train and probe; returns {"losses", "probe_acc", "state"}.
    ``params``: a flax tree for `load_jax_params` (None: its own init)."""
    dev = resolve_device(args.device)
    hg, _ = synthetic_hetero()
    ei_dict = {k: np.asarray(v) for k, v in hg.edge_index_dict.items()}
    n_dict = {"movie": hg["movie"].x.shape[0],
              "director": hg["director"].x.shape[0]}
    torch.manual_seed(args.seed)
    model = MetaPath2Vec(num_nodes_dict=n_dict, metapath=METAPATH,
                         embedding_dim=args.hidden_dim, walk_length=4)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    rng = np.random.default_rng(args.seed)
    total = sum(n_dict.values())
    losses = []
    for epoch in range(args.n_epoch):
        starts = rng.integers(0, n_dict["movie"], 128)
        walks = model.sample_walks(ei_dict, starts, rng=rng)
        neg = rng.integers(0, total, (walks.shape[0], 1, walks.shape[1]))
        model.train()
        loss = model(torch.from_numpy(walks).to(dev),
                     torch.from_numpy(neg).to(dev))
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        print(f"epoch {epoch:3d} loss {losses[-1]:.4f}")
    y = np.asarray(hg["movie"].y)
    d = {"y": torch.from_numpy(y).to(dev),
         "train_mask": torch.from_numpy(
             np.asarray(hg["movie"].train_mask)).to(dev),
         "test_mask": torch.from_numpy(
             np.asarray(hg["movie"].test_mask)).to(dev)}
    acc = linear_probe(model.embed("movie").detach(), d, int(y.max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": losses, "probe_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
