"""GLNN trainer: a GCN teacher distilled into a graph-free MLP student.

Twin of `examples/glnn/glnn_trainer.py`: a `GCNModel` teacher (no
dropout) trained ``--n_epoch`` steps of Adam on the masked cross-entropy,
then a `GLNNStudent` (no dropout) trained ``2 * --n_epoch`` steps on
`distill_loss` (lam 0.5, temperature 1) against the teacher's logits; the
student reads the features alone. The same flags, plus ``--device``.
COO on every device, as in JAX.

    python -m gammagl_tpu_torch.examples.glnn_trainer              # the card
    python -m gammagl_tpu_torch.examples.glnn_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import GCNModel, GLNNStudent, distill_loss
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "train_teacher"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def train_teacher(args, data, dev, params=None):
    """The distillation scripts' teacher: (the device graph, the trained
    `GCNModel`, its eval logits, its losses)."""
    d = device_graph(data, dev)
    torch.manual_seed(args.seed)
    teacher = GCNModel(hidden_dim=args.hidden_dim,
                       num_class=int(np.asarray(data["y"]).max()) + 1,
                       drop_rate=0.0)
    if params is not None:
        load_jax_params(teacher, params)
    state = TrainState(teacher.to(dev), args.lr)
    losses = []
    for _ in range(args.n_epoch):
        teacher.train()
        loss = semi_supervised_loss(teacher(d["x"], d["edge_index"]),
                                    d["y"], d["train_mask"])
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
    return d, teacher, predict(teacher, d["x"], d["edge_index"]), losses


def main(args, data=None, params=None):
    """Train both; returns {"teacher_losses", "losses" (the student's),
    "teacher_acc", "test_acc", "state"}. ``data`` as in
    `common.run_simple_node_trainer`; ``params``: {"teacher": flax tree,
    "student": flax tree} (None: their own init)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    params = params or {}
    d, _, t_logits, t_losses = train_teacher(args, data, dev,
                                             params.get("teacher"))
    t_acc = float(accuracy(t_logits, d["y"], d["test_mask"]))
    student = GLNNStudent(hidden_dim=args.hidden_dim,
                          num_class=t_logits.shape[1], drop_rate=0.0,
                          in_channels=d["x"].shape[1])
    if params.get("student") is not None:
        load_jax_params(student, params["student"])
    state = TrainState(student.to(dev), args.lr)
    losses = []
    for _ in range(args.n_epoch * 2):
        student.train()
        loss = distill_loss(student(d["x"]), t_logits, d["y"],
                            d["train_mask"], lam=0.5)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
    student.eval()
    with torch.no_grad():
        s_acc = float(accuracy(student(d["x"]), d["y"], d["test_mask"]))
    print(f"teacher acc {t_acc:.4f} -> student (no graph!) acc {s_acc:.4f} "
          f"({dev})")
    return {"teacher_losses": t_losses, "losses": losses,
            "teacher_acc": t_acc, "test_acc": s_acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
