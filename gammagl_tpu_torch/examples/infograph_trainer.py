"""InfoGraph trainer: graph-level mutual-information pretraining on a
batch of synthetic graphs, then a linear probe on the graph embeddings.

Twin of `examples/infograph/infograph_trainer.py`: the same 32 graphs of
12 nodes (`graph_batch`: the JAX script's numpy stream from ``--seed``),
the same model (`InfoGraph`, hidden ``--hidden_dim``, 2 GIN layers), the
same loop (Adam at ``--lr``, ``--n_epoch`` steps; then `linear_probe` on
the graph embeddings, the first half of the graphs to train) and the
same flags, plus ``--device``. The convs and the pool are the port's COO
ops on every device, as in JAX.

    python -m gammagl_tpu_torch.examples.infograph_trainer  # the card
    python -m gammagl_tpu_torch.examples.infograph_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import base_parser, linear_probe
from gammagl_tpu_torch.models import InfoGraph
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "graph_batch"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=30,
                       lr=0.001)


def graph_batch(seed, num_graphs=32, n=12):
    """The JAX script's batch: graph i of class i % 2 (edge density 0.5
    or 0.15), 8 normal features a node, all in one disjoint batch.
    Returns numpy (x, edge_index, batch, y)."""
    rng = np.random.default_rng(seed)
    xs, eis, batch, ys, off = [], [], [], [], 0
    for i in range(num_graphs):
        label = i % 2
        a = rng.random((n, n)) < (0.5 if label else 0.15)
        ei = np.stack(np.nonzero(a))
        xs.append(rng.normal(size=(n, 8)).astype(np.float32))
        eis.append(ei + off)
        batch.extend([i] * n)
        ys.append(label)
        off += n
    return (np.concatenate(xs), np.concatenate(eis, axis=1),
            np.asarray(batch), np.asarray(ys))


def main(args, data=None, params=None):
    """Pretrain and probe; returns {"losses", "probe_acc", "h_graph",
    "state"}. ``data``: (x, edge_index, batch, y) as `graph_batch`
    returns (None: `graph_batch(args.seed)`); ``params`` a flax-shaped
    tree for `load_jax_params` (None: the model's own init)."""
    dev = resolve_device(args.device)
    x, ei, batch, y = graph_batch(args.seed) if data is None else data
    num_graphs = len(y)
    x, ei, batch = (torch.from_numpy(np.asarray(a)).to(dev)
                    for a in (x, ei, batch))
    torch.manual_seed(args.seed)
    model = InfoGraph(hidden_dim=args.hidden_dim, num_layers=2,
                      in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss, _ = model(x, ei, batch, num_graphs)
        loss.backward()
        state.apply_gradients()
        losses.append(loss.detach())
        if epoch % 10 == 0:
            print(f"pretrain {epoch:4d} loss {float(losses[-1]):.4f}")
    model.eval()
    with torch.no_grad():
        _, h_graph = model(x, ei, batch, num_graphs)
    print("graph embeddings:", tuple(h_graph.shape))
    half = num_graphs // 2
    train_mask = torch.zeros(num_graphs, dtype=torch.bool, device=dev)
    train_mask[:half] = True
    d = {"y": torch.from_numpy(np.asarray(y)).to(dev),
         "train_mask": train_mask, "test_mask": ~train_mask}
    acc = linear_probe(h_graph, d, int(np.asarray(y).max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": [float(v) for v in losses], "probe_acc": acc,
            "h_graph": h_graph, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
