"""Specformer trainer: learned spectral filters over the full
eigendecomposition of the normalised Laplacian.

Twin of `examples/specformer/specformer_trainer.py`: the same model
(`SpecformerModel`, hidden ``--hidden_dim``, two filters, dropout
``--drop_rate``), the same spectrum (`laplacian_eigh` of the self-looped
graph: a full ``eigh`` on the host), the same loop (Adam at ``--lr`` on
the masked cross-entropy, the test accuracy after each step, the best
kept) and the same flags, plus ``--device``. Dropout draws from a
generator on the device seeded ``--seed`` + 1.

    python -m gammagl_tpu_torch.examples.specformer_trainer  # the card
    python -m gammagl_tpu_torch.examples.specformer_trainer --device cpu
"""

import time

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import SpecformerModel, laplacian_eigh
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=100,
                       lr=0.01, drop_rate=0.2)


def main(args, data=None, params=None):
    """Train; returns {"losses", "best_test", "eigh_s", "state"} (the
    host seconds of the eigendecomposition). ``data`` and ``params`` as
    in `run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    num_class = int(np.asarray(data["y"]).max()) + 1
    d = device_graph(data, dev)
    t0 = time.perf_counter()
    lam, u = laplacian_eigh(d["edge_index"].cpu().numpy(),
                            d["x"].shape[0])
    eigh_s = time.perf_counter() - t0
    lam, u = torch.from_numpy(lam).to(dev), torch.from_numpy(u).to(dev)
    torch.manual_seed(args.seed)
    model = SpecformerModel(num_class=num_class, hidden_dim=args.hidden_dim,
                            num_filters=2, drop_rate=args.drop_rate,
                            in_channels=d["x"].shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses, best = [], 0.0
    for epoch in range(args.n_epoch):
        model.train()
        loss = semi_supervised_loss(model(d["x"], lam, u, generator=gen),
                                    d["y"], d["train_mask"])
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        acc = float(accuracy(predict(model, d["x"], lam, eigenvectors=u),
                             d["y"], d["test_mask"]))
        best = max(best, acc)
        if epoch % 20 == 0:
            print(f"epoch {epoch:4d} loss {losses[-1]:.4f} test {acc:.4f}")
    print(f"best test acc {best:.4f} ({dev})")
    return {"losses": losses, "best_test": best, "eigh_s": eigh_s,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
