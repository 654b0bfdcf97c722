"""DeepWalk trainer: uniform random-walk skip-gram embeddings and a
linear probe.

Twin of `examples/deepwalk/deepwalk_trainer.py`: a `DeepWalk` table of
``--hidden_dim`` (walks of 10 steps, one negative walk each) trained by
Adam at ``--lr`` over `make_loader`'s batches of ``--batch_size`` walks
(the loader seeded ``--seed``; its first batch is drawn once before the
loop, as the JAX script draws it for ``init``) for ``--n_epoch`` epochs,
then `common.linear_probe` on the table. The same flags, plus
``--device``. The skip-gram gathers are COO indexing, as in JAX.

    python -m gammagl_tpu_torch.examples.deepwalk_trainer              # the card
    python -m gammagl_tpu_torch.examples.deepwalk_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               linear_probe, node_data)
from gammagl_tpu_torch.models import DeepWalk
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "train_walks"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=128, n_epoch=5,
                    lr=0.01)
    p.add_argument("--batch_size", type=int, default=256)
    return p


def train_walks(model, loader, n_epoch, lr, dev, params=None, log=True):
    """The JAX scripts' skip-gram loop: one batch drawn for init, then
    ``n_epoch`` passes over ``loader``, an Adam step a batch. Returns
    (the losses of every step, the state)."""
    next(iter(loader))  # the batch the JAX script draws for ``init``
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), lr)
    losses = []
    for epoch in range(n_epoch):
        for pos, neg in loader:
            model.train()
            loss = model(torch.from_numpy(pos).to(dev),
                         torch.from_numpy(neg).to(dev))
            loss.backward()
            state.apply_gradients()
            losses.append(loss.detach())
        if log:
            print(f"epoch {epoch:3d} loss {float(losses[-1]):.4f}")
    return [float(v) for v in losses], state


def main(args, model_cls=DeepWalk, data=None, params=None, **model_kw):
    """Train and probe; returns {"losses", "probe_acc", "state"}.
    ``data`` and ``params`` as in `common.run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    n = data["x"].shape[0]
    torch.manual_seed(args.seed)
    model = model_cls(num_nodes=n, embedding_dim=args.hidden_dim,
                      walk_length=10, **model_kw)
    loader = model.make_loader(np.asarray(data["edge_index"]),
                               batch_size=args.batch_size, seed=args.seed)
    losses, state = train_walks(model, loader, args.n_epoch, args.lr, dev,
                                params)
    acc = linear_probe(model().detach(), device_graph(data, dev),
                       int(np.asarray(data["y"]).max()) + 1)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": losses, "probe_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
