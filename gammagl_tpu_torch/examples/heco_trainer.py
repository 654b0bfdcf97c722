"""HeCo trainer: contrastive pretraining of HeCoModel, then a linear probe.

Twin of `examples/heco/heco_trainer.py`: the same graph (the synthetic
movie/director graph: the directs relation as the network schema, the
movie-director-movie relation as the one metapath, its pairs and every
movie with itself as the positives), the same model (`HeCoModel`,
``--hidden_dim`` wide, no feature dropout), ``--n_epoch`` full-graph Adam
steps at ``--lr`` on the contrastive loss, then `linear_probe` of the
metapath view's embeddings; and the same flags, plus ``--device``. Like
the JAX model it takes no plan: its sums are COO on every device.

    python -m gammagl_tpu_torch.examples.heco_trainer  # the card
    python -m gammagl_tpu_torch.examples.heco_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, linear_probe,
                                               predict, synthetic_hetero)
from gammagl_tpu_torch.models import HeCoModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "heco_inputs"]

SCHEMA = ("director", "directs", "movie")
METAPATH = ("movie", "mdm", "movie")


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=30,
                       lr=0.005)


def heco_inputs(hg, device):
    """(x_dict, schema edges, metapath edges, positives (N, N) bool) of
    the synthetic typed graph on ``device``."""
    def put(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    x_dict = {nt: put(np.asarray(hg[nt].x, np.float32))
              for nt in ("movie", "director")}
    mdm = np.asarray(hg[METAPATH].edge_index)
    n = x_dict["movie"].shape[0]
    pos = np.eye(n, dtype=bool)
    pos[mdm[0], mdm[1]] = True
    return (x_dict, {SCHEMA: put(hg[SCHEMA].edge_index)}, [put(mdm)],
            put(pos))


def main(args, params=None, log_every=10):
    """Pretrain and probe; returns {"losses", "test_acc", "model"}.
    ``params``: a flax-shaped tree for `load_jax_params` (None: the
    model's own init from ``args.seed``)."""
    dev = resolve_device(args.device)
    hg, target = synthetic_hetero()
    x_dict, ei_dict, mp_edges, pos = heco_inputs(hg, dev)
    torch.manual_seed(args.seed)
    model = HeCoModel((["movie", "director"], [SCHEMA]), target,
                      hidden_dim=args.hidden_dim, feat_drop=0.0,
                      in_channels={nt: x.shape[1]
                                   for nt, x in x_dict.items()})
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss = model(x_dict, ei_dict, mp_edges, pos)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % log_every == 0:
            print(f"pretrain {epoch:3d} loss {losses[-1]:.4f}")
    emb = predict(model, x_dict, ei_dict, metapath_edges=mp_edges)
    d = {k: torch.from_numpy(np.asarray(hg[target][k])).to(dev)
         for k in ("y", "train_mask", "test_mask")}
    acc = linear_probe(emb, d, int(d["y"].max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "model": model}


if __name__ == "__main__":
    main(parser().parse_args())
