"""AM-GCN / SFGCN trainer: GCNs over the topology graph and a kNN
feature graph, fused by attention.

Twin of `examples/amgcn/amgcn_trainer.py`: the same feature graph (each
node to its 5 most similar other rows by the inner product of the
features; `knn_graph`), the same model (`SFGCNModel`, ``--hidden_dim``),
the same loop (``--n_epoch`` steps of Adam at ``--lr`` on the masked
cross-entropy plus 0.01 times the consistency term; test accuracy every
10 epochs and at the end) and the same flags, plus ``--device``. The
model takes no plan, as in JAX: its sums are the port's COO ops on every
device.

    python -m gammagl_tpu_torch.examples.amgcn_trainer              # the card
    python -m gammagl_tpu_torch.examples.amgcn_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import SFGCNModel
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "knn_graph"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def knn_graph(x, k=5):
    """The JAX script's feature graph on numpy features: node i to the
    k rows after the first of argsort(-x x^T)[i] (the first is usually
    i itself)."""
    x = np.asarray(x)
    nn_idx = np.argsort(-(x @ x.T), axis=1)[:, 1:k + 1]
    return np.stack([np.repeat(np.arange(x.shape[0]), k),
                     nn_idx.reshape(-1)])


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "state"}. ``data`` and
    ``params`` as in `run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    fei = torch.from_numpy(knn_graph(np.asarray(data["x"], np.float32))
                           ).to(dev)
    model = SFGCNModel(num_class=int(d["y"].max()) + 1,
                       hidden_dim=args.hidden_dim, in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)

    def test_acc():
        return float(accuracy(predict(model, x, ei, feat_edge_index=fei)[0], d["y"],
                              d["test_mask"]))

    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        logits, consistency = model(x, ei, fei)
        loss = (semi_supervised_loss(logits, d["y"], d["train_mask"])
                + 0.01 * consistency)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"test {test_acc():.4f}")
    acc = test_acc()
    print(f"final test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
