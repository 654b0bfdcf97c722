"""LTD trainer: GLNN distillation with a learnt temperature a node.

Twin of `examples/ltd/ltd_trainer.py`: the glnn twin's teacher
(`glnn_trainer.train_teacher`), then a `GLNNStudent` (no dropout) and a
per-node log-temperature (zeros, (N, 1)) trained together ``2 *
--n_epoch`` steps of Adam on 0.5 * CE + 0.5 * KD, where KD is the soft
cross-entropy of the student's logits / T against softmax(teacher / T),
T = exp(log_temp). The same flags, plus ``--device``.

    python -m gammagl_tpu_torch.examples.ltd_trainer              # the card
    python -m gammagl_tpu_torch.examples.ltd_trainer --device cpu
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.examples.common import base_parser, node_data
from gammagl_tpu_torch.examples.glnn_trainer import train_teacher
from gammagl_tpu_torch.models import GLNNStudent
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["Student", "parser", "main"]


class Student(nn.Module):
    """The JAX script's trained tree: {"student": GLNNStudent's,
    "log_temp": (N, 1)}."""

    def __init__(self, num_nodes, hidden_dim, num_class, in_channels):
        super().__init__()
        self.student = GLNNStudent(hidden_dim=hidden_dim,
                                   num_class=num_class, drop_rate=0.0,
                                   in_channels=in_channels)
        self.log_temp = nn.Parameter(torch.zeros(num_nodes, 1))

    def flax_tree(self):
        return {"student": self.student, "log_temp": self.log_temp}

    def loss(self, x, t_logits, y, train_mask):
        temp = torch.exp(self.log_temp)
        soft = F.softmax(t_logits / temp, -1)
        logits = self.student(x)
        kd = -(soft * F.log_softmax(logits / temp, -1)).sum(-1).mean()
        return 0.5 * semi_supervised_loss(logits, y, train_mask) + 0.5 * kd


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def main(args, data=None, params=None):
    """Train both; returns {"teacher_losses", "losses", "test_acc",
    "state"}. ``params``: {"teacher": a flax tree, "student": {"params":
    {"student": the GLNNStudent's params, "log_temp": (N, 1)}}} (None:
    their own init)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    params = params or {}
    d, _, t_logits, t_losses = train_teacher(args, data, dev,
                                             params.get("teacher"))
    model = Student(d["x"].shape[0], args.hidden_dim, t_logits.shape[1],
                    d["x"].shape[1])
    if params.get("student") is not None:
        load_jax_params(model, params["student"])
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for _ in range(args.n_epoch * 2):
        model.train()
        loss = model.loss(d["x"], t_logits, d["y"], d["train_mask"])
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
    model.eval()
    with torch.no_grad():
        acc = float(accuracy(model.student(d["x"]), d["y"], d["test_mask"]))
    print(f"LTD student acc {acc:.4f} ({dev})")
    return {"teacher_losses": t_losses, "losses": losses, "test_acc": acc,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
