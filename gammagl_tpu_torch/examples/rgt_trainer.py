"""RGT trainer: self-supervised Riemannian graph transformer on
structure-extracted batches, then a linear probe on the seed nodes'
fused embeddings.

Twin of `examples/rgt/rgt_trainer.py`: the same batches
(`ExtractNodeLoader`: fanout [4, 2], ``--batch_size`` seeds, no
shuffling, trees of at most 8 edges, the sampler seeded ``--seed``), the
same model (`RGTModel`, hidden ``--hidden_dim``, embeddings 32, 2 layers,
4 codebooks of 64 codes of 16 dimensions), the same loop (``--n_epoch``
epochs of Adam at ``--lr`` on `train_loss`, one step a batch, no
dropout: the script's calls are deterministic), the same probe (the
fused embeddings of the seeds of the first 40 batches, `linear_probe`)
and the same flags, plus ``--device``. The model takes no plan, as in
JAX: its sums and softmax are the port's COO ops.

    python -m gammagl_tpu_torch.examples.rgt_trainer              # the card
    python -m gammagl_tpu_torch.examples.rgt_trainer --device cpu
"""

import itertools

import numpy as np
import torch

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.examples.common import (base_parser, linear_probe,
                                               node_data)
from gammagl_tpu_torch.loader import ExtractNodeLoader
from gammagl_tpu_torch.models import RGTModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "loader", "batch_args"]

PROBE_BATCHES = 40


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=2,
                       lr=0.001, batch_size=4)


def loader(data, args):
    """The script's `ExtractNodeLoader` over ``data``'s graph."""
    g = Graph(x=np.asarray(data["x"], np.float32),
              edge_index=np.asarray(data["edge_index"]))
    return ExtractNodeLoader(g, num_neighbors=[4, 2],
                             batch_size=args.batch_size, shuffle=False,
                             max_tree_edges=8, seed=args.seed)


def batch_args(b, dev):
    """A batch's (tokens, edges, tree, cycle, sequence, num_seeds) on
    ``dev``."""
    return tuple(torch.from_numpy(np.asarray(b[k])).to(dev) for k in (
        "x", "edge_index", "tree_edge_index", "cycle_edge_index",
        "seq_edge_index")) + (b.num_seeds,)


def main(args, data=None, params=None, max_steps=None):
    """Train and probe; returns {"losses" (each step's), "epoch_losses",
    "probe_acc", "state"}. ``params``: a flax-shaped tree for
    `load_jax_params` (None: the model's own init). ``max_steps`` ends the
    loop early (None: every batch of ``--n_epoch`` epochs)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    batches = loader(data, args)
    next(iter(batches))  # the script's init batch
    torch.manual_seed(args.seed)
    model = RGTModel(in_dim=np.asarray(data["x"]).shape[1],
                     hidden_dim=args.hidden_dim, embed_dim=32, n_layers=2,
                     codebook_size=64, codebook_dim=16, codebook_heads=4)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses, epoch_losses = [], []
    for epoch in range(args.n_epoch):
        if max_steps is not None and len(losses) >= max_steps:
            break
        n0 = len(losses)
        for b in batches:
            if max_steps is not None and len(losses) == max_steps:
                break
            loss, _ = model.train_loss(*batch_args(b, dev))
            loss.backward()
            state.apply_gradients()
            losses.append(float(loss.detach()))
        epoch_losses.append(float(np.mean(losses[n0:])))
        print(f"epoch {epoch:3d} loss {epoch_losses[-1]:.4f}")
    embs, ids = [], []
    with torch.no_grad():
        for b in itertools.islice(iter(batches), PROBE_BATCHES):
            _, fused = model.train_loss(*batch_args(b, dev))
            embs.append(fused[:b.num_seeds].cpu().numpy())
            ids.append(np.asarray(b.n_id)[:b.num_seeds])
    n = np.asarray(data["x"]).shape[0]
    emb = np.zeros((n, embs[0].shape[1]), np.float32)
    emb[np.concatenate(ids)] = np.concatenate(embs)
    y = np.asarray(data["y"])
    d = {"y": torch.from_numpy(y).to(dev),
         "train_mask": torch.from_numpy(np.asarray(data["train_mask"])
                                        .reshape(n, -1)[:, 0]).to(dev),
         "test_mask": torch.from_numpy(np.asarray(data["test_mask"])
                                       .reshape(n)).to(dev)}
    acc = linear_probe(torch.from_numpy(emb).to(dev), d, int(y.max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": losses, "epoch_losses": epoch_losses,
            "probe_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
