"""NodeID trainer: GNN layers with residual vector quantisation, whose
codes are compact node ids.

Twin of `examples/nodeid/nodeid_trainer.py`: the same model
(`NodeIDModel`: ``--hidden_dim``, 3 GAT layers, 32 codes a codebook, the
model's own dropout 0.5), the same loop (``--n_epoch`` steps of Adam at
``--lr`` on the masked cross-entropy plus 0.25 times the commitment loss,
in training mode: each step updates the codebooks' running statistics;
test accuracy every 10 epochs and at the end) and the same flags, plus
``--device``. The JAX script draws its dropout from one fixed key each
step; the twin draws from a generator on the device seeded ``--seed`` +
1. The model takes no plan, as in JAX: its attention and sums are the
port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.nodeid_trainer              # the card
    python -m gammagl_tpu_torch.examples.nodeid_trainer --device cpu
"""

import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import NodeIDModel
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "state"}. ``data`` as in
    `run_simple_node_trainer`; ``params``: flax variables (``params`` and
    ``vq_stats``) for `load_jax_params`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    model = NodeIDModel(in_channels=x.shape[1],
                        hidden_channels=args.hidden_dim,
                        out_channels=int(d["y"].max()) + 1, num_codes=32)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def test_acc():
        return float(accuracy(predict(model, x, ei)[0], d["y"],
                              d["test_mask"]))

    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        logits, commit, _, _ = model(x, ei, generator=gen)
        loss = (semi_supervised_loss(logits, d["y"], d["train_mask"])
                + 0.25 * commit)
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
