"""DGCNN trainer: DGCNNModel (sort pooling) on a batch of small graphs.

Twin of `examples/dgcnn/dgcnn_trainer.py`: the same batch (`graph_batch`:
``--num_graphs`` graphs of 12 nodes and 8 features, drawn from numpy's
seed 0, dense graphs of class 1 and sparse ones of class 0), the same
model (`DGCNNModel`, hidden ``--hidden_dim``, k = 6), the same loop (Adam
at ``--lr`` on the mean cross-entropy of the graph labels, train accuracy
every 10 epochs after the step and at the end) and the same flags, plus
``--device``. Like the JAX model it takes no plan: its EdgeConvs' maxima
are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.dgcnn_trainer              # the card
    python -m gammagl_tpu_torch.examples.dgcnn_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import base_parser, predict
from gammagl_tpu_torch.models import DGCNNModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["graph_batch", "parser", "main"]


def graph_batch(num_graphs, seed=0):
    """The JAX trainer's disjoint batch, drawn from the same numpy stream:
    graph i has 12 nodes, label i % 2, each ordered pair an edge with
    probability 0.5 (label 1) or 0.15 (label 0), normal features of 8
    columns. Returns a dict of numpy arrays (x, edge_index, batch, y) and
    num_graphs."""
    rng = np.random.default_rng(seed)
    xs, eis, batch, ys = [], [], [], []
    off = 0
    for i in range(num_graphs):
        n = 12
        label = i % 2
        a = rng.random((n, n)) < (0.5 if label else 0.15)
        eis.append(np.stack(np.nonzero(a)) + off)
        xs.append(rng.normal(size=(n, 8)).astype(np.float32))
        batch.extend([i] * n)
        ys.append(label)
        off += n
    return {"x": np.concatenate(xs), "edge_index": np.concatenate(eis, 1),
            "batch": np.asarray(batch), "y": np.asarray(ys),
            "num_graphs": num_graphs}


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                       lr=0.005, num_graphs=32)


def main(args, data=None, params=None):
    """Train; returns {"losses", "train_acc", "state"}. ``data``: a dict
    as `graph_batch` returns (None: ``graph_batch(args.num_graphs)``);
    ``params``: a flax-shaped tree for `load_jax_params` (None: the
    model's own init from ``args.seed``)."""
    dev = resolve_device(args.device)
    data = graph_batch(args.num_graphs) if data is None else data

    def put(key, dtype=None):
        return torch.from_numpy(np.asarray(data[key], dtype)).to(dev)

    x, ei, batch, y = (put("x", np.float32), put("edge_index"),
                       put("batch"), put("y"))
    ng = data["num_graphs"]
    torch.manual_seed(args.seed)
    model = DGCNNModel(hidden_dim=args.hidden_dim, num_class=2, k=6,
                       in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)

    def train_acc():
        logits = predict(model, x, ei, batch=batch, num_graphs=ng)
        return float((logits.argmax(1) == y).float().mean())

    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss = F.cross_entropy(model(x, ei, batch, ng).float(), y)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"acc {train_acc():.4f}")
    acc = train_acc()
    print(f"final train acc {acc:.4f} ({dev})")
    return {"losses": losses, "train_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
