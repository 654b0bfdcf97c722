"""DFAD-GNN trainer: data-free adversarial distillation of a GCN teacher.

Twin of `examples/dfad_gnn/dfad_gnn_trainer.py`: the glnn twin's teacher
(`glnn_trainer.train_teacher`), then ``--n_epoch`` rounds of a student
step (a `GLNNStudent` matches the teacher on features a `GraphEditer`
generates, `dfad_student_loss`) and a generator step (the generator
maximises their disagreement, `dfad_generator_loss`), each model with
its own Adam of ``--lr``. The same flags, plus ``--device``.

    python -m gammagl_tpu_torch.examples.dfad_gnn_trainer              # the card
    python -m gammagl_tpu_torch.examples.dfad_gnn_trainer --device cpu
"""

import torch

from gammagl_tpu_torch.examples.common import base_parser, node_data
from gammagl_tpu_torch.examples.glnn_trainer import train_teacher
from gammagl_tpu_torch.models import (GLNNStudent, GraphEditer,
                                      dfad_generator_loss, dfad_student_loss)
from gammagl_tpu_torch.train import TrainState, accuracy
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def main(args, data=None, params=None):
    """Train; returns {"teacher_losses", "losses": [(student, generator)
    a round], "test_acc", "state"}. ``params``: {"teacher", "student",
    "generator"} flax trees (None: their own init)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    params = params or {}
    d, teacher, t_logits, t_losses = train_teacher(args, data, dev,
                                                   params.get("teacher"))
    x, ei = d["x"], d["edge_index"]
    teacher.eval()
    for p in teacher.parameters():
        p.requires_grad_(False)
    student = GLNNStudent(hidden_dim=args.hidden_dim,
                          num_class=t_logits.shape[1], drop_rate=0.0,
                          in_channels=x.shape[1])
    gen = GraphEditer(num_features=x.shape[1])
    for module, key in ((student, "student"), (gen, "generator")):
        if params.get(key) is not None:
            load_jax_params(module, params[key])
    s_state = TrainState(student.to(dev), args.lr)
    g_state = TrainState(gen.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        student.train()
        with torch.no_grad():
            xg = gen(x)
            tg = teacher(xg, ei)
        s_loss = dfad_student_loss(student(xg), tg)
        s_loss.backward()
        s_state.apply_gradients()
        xg = gen(x)
        g_loss = dfad_generator_loss(student(xg), teacher(xg, ei))
        g_loss.backward()
        student.zero_grad(set_to_none=True)  # the student is held fixed
        g_state.apply_gradients()
        losses.append((float(s_loss.detach()), float(g_loss.detach())))
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} student {losses[-1][0]:.4f} "
                  f"generator {losses[-1][1]:.4f}")
    student.eval()
    with torch.no_grad():
        acc = float(accuracy(student(x), d["y"], d["test_mask"]))
    print(f"data-free student acc {acc:.4f} ({dev})")
    return {"teacher_losses": t_losses, "losses": losses, "test_acc": acc,
            "state": s_state}


if __name__ == "__main__":
    main(parser().parse_args())
