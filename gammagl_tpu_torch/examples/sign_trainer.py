"""SIGN trainer: the K propagated feature sets computed once, then an MLP
trained on them (no edges in the training step).

Twin of `examples/sign/sign_trainer.py`: the same precompute
(`transforms.SIGN` with K = ``--K`` on the graph as loaded, no
self-loops), the same model (`SIGNModel`, ``--hidden_dim``,
``--drop_rate``), the same loop (``--n_epoch`` steps of Adam at ``--lr``
on the masked cross-entropy, dropout drawn from a generator on the device
seeded ``--seed`` + 1; test accuracy at the end) and the same flags, plus
``--device``. The precompute runs on the host in numpy, as in JAX; on the
card the step is dense products only.

    python -m gammagl_tpu_torch.examples.sign_trainer              # the card
    python -m gammagl_tpu_torch.examples.sign_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.examples.common import base_parser, node_data
from gammagl_tpu_torch.models import SIGNModel
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.transforms import SIGN
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "sign_features"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=100,
                       lr=0.005, drop_rate=0.3, K=3)


def sign_features(data, K):
    """[x, x1..xK] of `transforms.SIGN` on the loaded graph, numpy."""
    graph = SIGN(K=K)(Graph(x=np.asarray(data["x"], np.float32),
                            edge_index=np.asarray(data["edge_index"])))
    return [np.asarray(graph.x, np.float32)] + [
        np.asarray(graph[f"x{k}"]) for k in range(1, K + 1)]


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "state"}. ``data`` and
    ``params`` as in `run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    xs = [torch.from_numpy(a).to(dev) for a in sign_features(data, args.K)]
    y = torch.from_numpy(np.asarray(data["y"])).to(dev)
    train_mask = torch.from_numpy(np.asarray(data["train_mask"])).to(dev)
    test_mask = torch.from_numpy(np.asarray(data["test_mask"])).to(dev)
    model = SIGNModel(num_class=int(y.max()) + 1, hidden_dim=args.hidden_dim,
                      K=args.K, drop_rate=args.drop_rate,
                      in_channels=xs[0].shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    for _ in range(args.n_epoch):
        model.train()
        loss = semi_supervised_loss(model(xs, gen), y, train_mask)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
    model.eval()
    with torch.no_grad():
        acc = float(accuracy(model(xs), y, test_mask))
    print(f"SIGN K={args.K} test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
