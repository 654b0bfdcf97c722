"""DR-GST trainer: self-training with confidence-thresholded pseudo-labels.

Twin of `examples/drgst/drgst_trainer.py`: ``--stages`` stages, each
``--n_epoch`` steps of Adam (a fresh optimizer a stage, the parameters
carried over) of a `GCNModel` (no dropout) on the masked cross-entropy,
then every node outside the training set whose softmax confidence passes
``--threshold`` joins it with its predicted label; the test accuracy a
stage. The same flags, plus ``--device``. COO on every device, as in JAX.

    python -m gammagl_tpu_torch.examples.drgst_trainer              # the card
    python -m gammagl_tpu_torch.examples.drgst_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=30,
                       lr=0.01, stages=3, threshold=0.9)


def main(args, data=None, params=None):
    """Train; returns {"losses" (every step of every stage), "added" (the
    pseudo-labels a stage), "test_acc", "state"}. ``data`` and ``params``
    as in `common.run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    torch.manual_seed(args.seed)
    model = GCNModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     drop_rate=0.0)
    if params is not None:
        load_jax_params(model, params)
    model.to(dev)
    train_mask = d["train_mask"].clone()
    y = d["y"].clone()
    losses, added, acc = [], [], 0.0
    for stage in range(args.stages):
        state = TrainState(model, args.lr)
        for _ in range(args.n_epoch):
            model.train()
            loss = semi_supervised_loss(model(x, ei), y, train_mask)
            loss.backward()
            state.apply_gradients()
            losses.append(float(loss.detach()))
        probs = torch.softmax(predict(model, x, ei), -1)
        conf, pred = probs.max(1)
        new = (conf > args.threshold) & ~train_mask
        y = torch.where(new, pred, y)
        train_mask = train_mask | new
        acc = float(accuracy(predict(model, x, ei), d["y"], d["test_mask"]))
        added.append(int(new.sum()))
        print(f"stage {stage}: +{added[-1]} pseudo-labels, test acc "
              f"{acc:.4f}")
    return {"losses": losses, "added": added, "test_acc": acc,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
