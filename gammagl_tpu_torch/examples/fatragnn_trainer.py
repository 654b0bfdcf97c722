"""FatraGNN trainer: fair node classification under an edited graph, on
a synthetic graph with a sensitive attribute.

Twin of `examples/fatragnn/fatragnn_trainer.py`: the same graph (300
nodes, 16 features, binary labels, a sensitive attribute agreeing with
the label 70% of the time, 2,400 edges mostly between nodes of one
parity, half the nodes for training; drawn from
``np.random.default_rng(--seed)``), the same edit (`modify_structure`,
drop 0.6), the same model (`FatraGNNModel`, ``--hidden_dim``), the same
loop (``--n_epoch`` steps of Adam at ``--lr`` on the masked binary
cross-entropy plus 0.5 times the squared gap between the unit encodings
of the graph and of the edited one), the test accuracy and the
statistical-parity gap, and the same flags, plus ``--device``. The
encoder takes no plan, as in JAX: its sums are the port's COO ops on
every device.

    python -m gammagl_tpu_torch.examples.fatragnn_trainer              # the card
    python -m gammagl_tpu_torch.examples.fatragnn_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import base_parser, predict
from gammagl_tpu_torch.models import FatraGNNModel, modify_structure
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "fairness_graph"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def fairness_graph(seed, n=300, f=16):
    """The JAX script's graph, numpy: (x, edge_index, y, sens,
    train_mask)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    sens = np.where(rng.random(n) < 0.7, y, 1 - y)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 0] += y * 1.5
    x[:, 1] += sens * 1.0
    src = rng.integers(0, n, 8 * n)
    same = rng.random(8 * n) < 0.8
    dst = np.where(same, (src + rng.integers(1, 10, 8 * n) * 2) % n,
                   rng.integers(0, n, 8 * n))
    train_mask = rng.random(n) < 0.5
    return x, np.stack([src, dst]), y, sens, train_mask


def main(args, params=None):
    """Train and score; returns {"losses", "test_acc", "parity_gap",
    "state"}. ``params``: a flax-shaped tree for `load_jax_params` (None:
    the model's own init)."""
    dev = resolve_device(args.device)
    x, ei, y, sens, train_mask = fairness_graph(args.seed)
    ei2 = modify_structure(ei, ei, sens, drop=0.6)
    xt, eit, ei2t = (torch.from_numpy(a).to(dev) for a in (x, ei, ei2))
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)
    tm = torch.from_numpy(train_mask).to(dev)
    model = FatraGNNModel(num_features=x.shape[1], hidden=args.hidden_dim)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        logits = model(xt, eit, 0)[:, 0]
        ce = F.binary_cross_entropy_with_logits(logits, yt,
                                                reduction="none")
        ce = torch.where(tm, ce, 0).sum() / tm.sum()
        out = model(xt, eit, 5, edge_index2=ei2t)
        align = ((out["h1"] - out["h2"]) ** 2).sum(1).mean()
        loss = ce + 0.5 * align
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f}")
    pred = (predict(model, xt, eit, flag=0)[:, 0] > 0).cpu().numpy()
    test = ~train_mask
    acc = float((pred[test] == y[test].astype(bool)).mean())
    gap = float(abs(pred[test & (sens == 0)].mean()
                    - pred[test & (sens == 1)].mean()))
    print(f"test acc {acc:.4f}, parity gap {gap:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "parity_gap": gap,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
