"""Sp2GCL trainer: contrast a spatial view (GCN) against a spectral one
(Laplacian eigenvectors), then a linear probe.

Twin of `examples/sp2gcl/sp2gcl_trainer.py`: the same eigenvectors (the
first ``--spe_dim`` of `laplacian_eigh` of the self-looped graph, on the
host), the same model (`Sp2GCLModel`, ``--hidden_dim``), the same loop
(``--n_epoch`` steps of Adam at ``--lr`` on the model's loss) and the
same flags, plus ``--device``. As in the JAX script (its model has no
``embed``), the probe reads the input features. The model takes no plan,
as in JAX: its sums are the port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.sp2gcl_trainer              # the card
    python -m gammagl_tpu_torch.examples.sp2gcl_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               linear_probe, node_data)
from gammagl_tpu_torch.models import Sp2GCLModel, laplacian_eigh
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=30,
                       lr=0.001, spe_dim=16)


def main(args, data=None, params=None):
    """Pretrain and probe; returns {"losses", "probe_acc", "state"}.
    ``data`` and ``params`` as in `run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    _, u = laplacian_eigh(ei.cpu().numpy(), x.shape[0])
    u = torch.from_numpy(np.ascontiguousarray(u[:, :args.spe_dim])).to(dev)
    model = Sp2GCLModel(hidden_dim=args.hidden_dim, in_channels=x.shape[1],
                        spe_dim=u.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss = model(x, ei, u)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 20 == 0:
            print(f"pretrain {epoch:4d} loss {losses[-1]:.4f}")
    acc = linear_probe(x, d, int(d["y"].max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": losses, "probe_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
