"""CompGCN trainer: CompGCNModel on the typed graph's homogeneous view.

Twin of `examples/compgcn/compgcn_trainer.py`: the same graph (the
synthetic movie/director graph flattened to one node set whose edges
carry their relation as a type: `typed_graph`), the same
model (`CompGCNModel`, hidden ``--hidden_dim``, one relation embedding a
relation), the same loop (Adam at ``--lr`` on the masked cross-entropy of
the movie rows, test accuracy every 10 epochs after the step and at the
end) and the same flags, plus ``--device``. Like the JAX model it takes
no plan: its sums are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.compgcn_trainer              # the card
    python -m gammagl_tpu_torch.examples.compgcn_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples import simplehgn_trainer
from gammagl_tpu_torch.examples.common import base_parser, predict
from gammagl_tpu_torch.models import CompGCNModel
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["typed_graph", "parser", "main"]


def typed_graph():
    """The JAX trainer's homogeneous view of `synthetic_hetero`: movies
    then directors, each relation's edges offset into that order and typed
    by the relation's place (the simplehgn twin's `typed_graph`), and the
    number of movies."""
    data = simplehgn_trainer.typed_graph()
    data["num_movies"] = int(data["y"].shape[0])
    return data


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                       lr=0.005)


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "state"}. ``data``: a dict as
    `typed_graph` returns (None: that graph); ``params``: a flax-shaped
    tree for `load_jax_params` (None: the model's own init from
    ``args.seed``)."""
    dev = resolve_device(args.device)
    data = typed_graph() if data is None else data

    def put(key, dtype=None):
        return torch.from_numpy(np.asarray(data[key], dtype)).to(dev)

    x, ei, et = put("x", np.float32), put("edge_index"), put("edge_type")
    y, train_mask, test_mask = put("y"), put("train_mask"), put("test_mask")
    n_m = data["num_movies"]
    torch.manual_seed(args.seed)
    model = CompGCNModel(data["num_relations"], hidden_dim=args.hidden_dim,
                         num_class=int(y.max()) + 1,
                         in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)

    def test_acc():
        return float(accuracy(predict(model, x, ei, edge_type=et)[:n_m], y,
                              test_mask))

    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss = semi_supervised_loss(model(x, ei, et)[:n_m], y, train_mask)
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
