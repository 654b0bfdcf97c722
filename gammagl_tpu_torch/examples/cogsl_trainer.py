"""CoGSL trainer: two structure views, confidence-fused, with a
contrastive alignment term.

Twin of `examples/cogsl/cogsl_trainer.py`: the dataset's graph (with
self-loops) as the first view and, as the second, up to 4,000 of its
edges drawn from ``np.random.default_rng(--seed)``, reversed; a
`CoGSLModel` of ``--hidden_dim`` trained ``--n_epoch`` steps of Adam at
``--lr`` on CE(fused) + 0.5 CE(view 1) + 0.5 CE(view 2) - 0.1 * the GRACE
term; the fused view's test accuracy every 10 epochs and at the end. The
same flags, plus ``--device``. Its GCNConvs take no plan (COO on every
device), as in JAX.

    python -m gammagl_tpu_torch.examples.cogsl_trainer              # the card
    python -m gammagl_tpu_torch.examples.cogsl_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data)
from gammagl_tpu_torch.models import CoGSLModel
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "second_view", "cogsl_loss"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.005)


def second_view(edge_index, seed):
    """The JAX script's second view, numpy: up to 4,000 edges drawn with
    replacement from ``np.random.default_rng(seed)``, reversed."""
    ei = np.asarray(edge_index)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, ei.shape[1], min(4000, ei.shape[1]))
    return ei[:, idx][::-1].copy()


def cogsl_loss(out, y, mask):
    (l1, l2, lf), mi = out
    return (semi_supervised_loss(lf, y, mask)
            + 0.5 * semi_supervised_loss(l1, y, mask)
            + 0.5 * semi_supervised_loss(l2, y, mask) - 0.1 * mi)


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "state"}. ``data`` and
    ``params`` as in `common.run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    e2 = torch.from_numpy(second_view(ei.cpu().numpy(), args.seed)).to(dev)
    torch.manual_seed(args.seed)
    model = CoGSLModel(num_class=int(np.asarray(data["y"]).max()) + 1,
                       hidden_dim=args.hidden_dim, in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    def fused_acc():
        model.eval()
        with torch.no_grad():
            (_, _, lf), _ = model(x, ei, e2)
        return float(accuracy(lf, d["y"], d["test_mask"]))

    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss = cogsl_loss(model(x, ei, e2), d["y"], d["train_mask"])
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} test "
                  f"{fused_acc():.4f}")
    acc = fused_acc()
    print(f"final test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
