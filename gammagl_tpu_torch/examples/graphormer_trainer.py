"""Graphormer trainer: graph classification of a synthetic set of dense
and sparse graphs.

Twin of `examples/graphormer/graphormer_trainer.py`: the same graphs
(``--num_graphs`` graphs of 16 nodes from ``np.random.default_rng(--seed)``
in the script's order: graph i has label i % 2, dense (p 0.5) or sparse
(p 0.15) random directed edges, 8 normal features, hop distances clipped
at 5), the same model (`GraphormerModel`, ``--hidden_dim``, 2 layers, 2
heads, 2 classes, no dropout), the same loop (``--n_epoch`` epochs of one
Adam step at ``--lr`` a graph on its cross-entropy, then the accuracy)
and the same flags, plus ``--device``. Each graph's attention is a dense
softmax: no kernel.

    python -m gammagl_tpu_torch.examples.graphormer_trainer              # the card
    python -m gammagl_tpu_torch.examples.graphormer_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import base_parser
from gammagl_tpu_torch.models import GraphormerModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import (load_jax_params, resolve_device,
                                     shortest_path)

__all__ = ["parser", "main", "graphs"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=5,
                       lr=0.001, num_graphs=16)


def graphs(seed, num_graphs, n=16):
    """The script's graphs as numpy: [(x (n, 8), in-degree, out-degree,
    distances (n, n), label)]."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(num_graphs):
        label = i % 2
        a = rng.random((n, n)) < (0.5 if label else 0.15)
        ei = np.stack(np.nonzero(a))
        x = rng.normal(size=(n, 8)).astype(np.float32)
        dist = shortest_path(ei, n, max_dist=5)
        ind = np.bincount(ei[1], minlength=n).astype(np.int32)
        outd = np.bincount(ei[0], minlength=n).astype(np.int32)
        out.append((x, ind, outd, dist, label))
    return out


def main(args, params=None):
    """Train; returns {"losses" (each step's), "epoch_losses", "acc",
    "state"}. ``params``: a flax-shaped tree for `load_jax_params` (None:
    the model's own init)."""
    dev = resolve_device(args.device)
    data = [tuple(torch.as_tensor(a).to(dev) for a in g[:4])
            + (torch.tensor([g[4]], device=dev),)
            for g in graphs(args.seed, args.num_graphs)]
    torch.manual_seed(args.seed)
    model = GraphormerModel(hidden_dim=args.hidden_dim, num_class=2,
                            num_layers=2, num_heads=2, dropout_rate=0.0,
                            in_channels=8)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses, epoch_losses, acc = [], [], 0.0
    for epoch in range(args.n_epoch):
        model.train()
        total = []
        for x, ind, outd, dist, y in data:
            loss = F.cross_entropy(model(x, ind, outd, dist)[None], y)
            loss.backward()
            state.apply_gradients()
            total.append(loss.detach())
        losses += [float(v) for v in total]
        epoch_losses.append(float(np.mean(losses[-len(data):])))
        model.eval()
        with torch.no_grad():
            acc = sum(int(model(*g[:4]).argmax()) == int(g[4])
                      for g in data) / len(data)
        print(f"epoch {epoch:3d} loss {epoch_losses[-1]:.4f} "
              f"acc {acc:.4f}")
    return {"losses": losses, "epoch_losses": epoch_losses, "acc": acc,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
