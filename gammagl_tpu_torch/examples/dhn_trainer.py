"""DHN trainer: link prediction from each endpoint's distance-encoded
neighbourhood block, on synthetic blocks.

Twin of `examples/dhn/dhn_trainer.py`: the same batches (64 pairs of
blocks of K = 4 neighbours of F = 8 features, the positive pairs sharing
a planted direction, all drawn from ``np.random.default_rng(--seed)`` in
the script's order: one batch for the init, one a step, 8 held out), the
same model (`DHNModel`, ``--hidden_dim``), the same loop (``--n_epoch``
steps of Adam at ``--lr`` on the binary cross-entropy of the scores,
each step on a fresh batch), the held-out AUC (`binary_auc`) and the
same flags, plus ``--device``. No graph is read: the model is dense maps.

    python -m gammagl_tpu_torch.examples.dhn_trainer              # the card
    python -m gammagl_tpu_torch.examples.dhn_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import base_parser, binary_auc
from gammagl_tpu_torch.models import DHNModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "batches", "K", "F_DIM", "B"]

K, F_DIM, B = 4, 8, 64


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=30,
                       lr=0.005)


def batches(seed):
    """The JAX script's batch stream: an endless iterator of (n1, n2, y)
    numpy arrays from one ``default_rng(seed)``."""
    width = F_DIM + K * F_DIM + K * K * F_DIM
    rng = np.random.default_rng(seed)
    while True:
        n1 = rng.normal(size=(B, width)).astype(np.float32)
        n2 = rng.normal(size=(B, width)).astype(np.float32)
        y = rng.integers(0, 2, B).astype(np.float32)
        sig = rng.normal(size=(width,)).astype(np.float32)
        n2 += y[:, None] * sig * 0.8
        yield n1, n2, y


def main(args, params=None):
    """Train and score; returns {"losses", "auc", "state"}. ``params``: a
    flax-shaped tree for `load_jax_params` (None: the model's own
    init)."""
    dev = resolve_device(args.device)
    stream = batches(args.seed)

    def batch():
        return tuple(torch.from_numpy(a).to(dev) for a in next(stream))

    model = DHNModel(num_fea=F_DIM, num_neighbor=K, hidden=args.hidden_dim)
    batch()  # the JAX script's init batch
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    model.train()
    losses = []
    for epoch in range(args.n_epoch):
        n1, n2, y = batch()
        loss = F.binary_cross_entropy_with_logits(model(n1, n2)[:, 0], y)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 5 == 0:
            with torch.no_grad():
                acc = float(((model(n1, n2)[:, 0] > 0) == (y > 0.5))
                            .float().mean())
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} acc {acc:.4f}")
    scores, ys = [], []
    with torch.no_grad():
        for _ in range(8):
            n1, n2, y = batch()
            scores.append(model(n1, n2)[:, 0].cpu().numpy())
            ys.append(y.cpu().numpy())
    auc = binary_auc(np.concatenate(scores), np.concatenate(ys))
    print(f"held-out AUC {auc:.4f} ({dev})")
    return {"losses": losses, "auc": auc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
