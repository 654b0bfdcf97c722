"""GraphGAN trainer: the generator/discriminator embedding game, scored by
link-prediction AUC.

Twin of `examples/graphgan/graphgan_trainer.py`: a `GraphGAN` of
``--hidden_dim`` on the dataset's edges; each epoch a batch of 256 true
edges and 256 random pairs (``np.random.default_rng(--seed)``, the JAX
script's draws; one batch is drawn before the loop, as the script draws
it for ``init``), a discriminator step on all 512, then a generator step
on the 256 (u, fake) pairs. Both steps take one Adam of ``--lr`` over all
four parameters, as the script's one optax state: a parameter a step's
loss does not reach gets a zero gradient, so its moments decay and it
still moves, as under optax. Then the discriminator's AUC on 8 fresh
batches (`common.binary_auc`). The same flags, plus ``--device``.

    python -m gammagl_tpu_torch.examples.graphgan_trainer              # the card
    python -m gammagl_tpu_torch.examples.graphgan_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, binary_auc,
                                               node_data)
from gammagl_tpu_torch.models import GraphGAN
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "step_all"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=5,
                       lr=0.001)


def step_all(state, loss):
    """Backward ``loss`` and take an Adam step over every parameter: a
    parameter the loss does not reach gets a zero gradient (optax's one
    state over the whole tree), not none (which torch's Adam skips)."""
    loss.backward()
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.apply_gradients()
    return float(loss.detach())


def main(args, data=None, params=None):
    """Train and score; returns {"losses": [(D, G) an epoch], "auc",
    "state"}. ``data`` and ``params`` as in
    `common.run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    ei = np.asarray(data["edge_index"])
    n = data["x"].shape[0]
    rng = np.random.default_rng(args.seed)

    def batch():
        pos = ei[:, rng.integers(0, ei.shape[1], 256)]
        fake = rng.integers(0, n, 256)
        u = np.concatenate([pos[0], pos[0]])
        v = np.concatenate([pos[1], fake])
        lab = np.concatenate([np.ones(256), np.zeros(256)])
        return (torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev),
                torch.from_numpy(lab).float().to(dev))

    batch()  # the JAX script's init batch
    torch.manual_seed(args.seed)
    model = GraphGAN(num_nodes=n, embedding_dim=args.hidden_dim)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        u, v, lab = batch()
        d_loss = step_all(state, model(u, v, lab))
        g_loss = step_all(state, model(u[:256], v[256:]))
        losses.append((d_loss, g_loss))
        print(f"epoch {epoch:3d} D {d_loss:.4f} G {g_loss:.4f}")
    scores, ys = [], []
    with torch.no_grad():
        for _ in range(8):
            u, v, lab = batch()
            scores.append(model.dis_score(u, v).cpu().numpy())
            ys.append(lab.cpu().numpy())
    auc = binary_auc(np.concatenate(scores), np.concatenate(ys))
    print(f"link-pred AUC {auc:.4f} ({dev})")
    return {"losses": losses, "auc": auc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
