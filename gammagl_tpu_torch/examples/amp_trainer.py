"""AMP trainer: adaptive message passing, each node halting after a
learned number of propagation steps.

Twin of `examples/amp/amp_trainer.py`: the same model (`AMPModel`,
``--hidden_dim``, at most 4 steps), the same loop (``--n_epoch`` steps of
Adam at ``--lr`` on the masked cross-entropy; test accuracy and the mean
depth every 10 epochs and at the end) and the same flags, plus
``--device``. The model takes no plan, as in JAX: its propagation is the
port's COO spmm on every device.

    python -m gammagl_tpu_torch.examples.amp_trainer              # the card
    python -m gammagl_tpu_torch.examples.amp_trainer --device cpu
"""

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import AMPModel
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "depth", "state"}. ``data``
    and ``params`` as in `run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    model = AMPModel(num_class=int(d["y"].max()) + 1,
                     hidden_dim=args.hidden_dim, max_steps=4,
                     in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)

    def evaluate():
        logits, depth = predict(model, x, ei)
        return float(accuracy(logits, d["y"], d["test_mask"])), float(depth)

    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        logits, _ = model(x, ei)
        loss = semi_supervised_loss(logits, d["y"], d["train_mask"])
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            acc, depth = evaluate()
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} test {acc:.4f} "
                  f"depth {depth:.2f}")
    acc, depth = evaluate()
    print(f"final test acc {acc:.4f} (mean depth {depth:.2f}, {dev})")
    return {"losses": losses, "test_acc": acc, "depth": depth,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
