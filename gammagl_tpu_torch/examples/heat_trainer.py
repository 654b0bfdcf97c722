"""HEAT trainer: trajectory prediction with edge-enhanced attention, on
synthetic agents.

Twin of `examples/heat/heat_trainer.py`: the same scenes (16 agents of 5
history steps, 48 random proximity edges with 5 attributes and 4 types,
6 future offsets extrapolating each agent's velocity; scene s drawn from
``np.random.default_rng(s)``, step e on scene e), the same model
(`HEATModel`: 16 wide, 32 out, 2 heads), the same loop (``--n_epoch``
steps of Adam at ``--lr`` on the mean squared error; the JAX script's
steps call the model without ``train=True``, so the twin's steps run
without dropout too) and the same flags, plus ``--device``. The model
takes no plan, as in JAX: its softmax and sums are the port's COO ops on
every device.

    python -m gammagl_tpu_torch.examples.heat_trainer              # the card
    python -m gammagl_tpu_torch.examples.heat_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import base_parser
from gammagl_tpu_torch.models import HEATModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "scene"]

AGENTS, EDGES, HIST, FUT = 16, 48, 5, 6


def parser():
    return base_parser(__doc__.splitlines()[0], n_epoch=30, lr=0.005)


def scene(seed):
    """(x (16, 5, 4), edge_index, edge attributes, one-hot edge types,
    future offsets (16, 12)) of the JAX script's ``batch(seed)``, numpy."""
    r = np.random.default_rng(seed)
    vel = r.normal(size=(AGENTS, 1, 2))
    t = np.arange(HIST).reshape(1, HIST, 1)
    x = vel * t + 0.05 * r.normal(size=(AGENTS, HIST, 2))
    xf = np.concatenate([x, np.broadcast_to(vel, (AGENTS, HIST, 2))], -1)
    ei = np.stack([r.integers(0, AGENTS, EDGES), r.integers(0, AGENTS,
                                                            EDGES)])
    attr = r.normal(size=(EDGES, 5)).astype(np.float32)
    etype = np.eye(4, dtype=np.float32)[r.integers(0, 4, EDGES)]
    tfut = HIST + np.arange(FUT).reshape(1, FUT, 1)
    yfut = (vel * tfut).reshape(AGENTS, FUT * 2)
    return (xf.astype(np.float32), ei, attr, etype,
            yfut.astype(np.float32))


def main(args, params=None):
    """Train; returns {"losses", "state"}. ``params``: a flax-shaped tree
    for `load_jax_params` (None: the model's own init)."""
    dev = resolve_device(args.device)
    model = HEATModel(in_channels_node=16, out_channels=32, out_length=FUT,
                      node_emb_size=16, edge_attr_emb_size=16,
                      edge_type_emb_size=16, heads=2,
                      in_channels=HIST * 4, edge_attr_channels=5,
                      edge_type_channels=4)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    model.eval()  # the JAX steps run the model in its inference mode
    losses = []
    for epoch in range(args.n_epoch):
        x, ei, attr, etype, y = (torch.from_numpy(a).to(dev)
                                 for a in scene(epoch))
        loss = ((model(x, ei, attr, etype) - y) ** 2).mean()
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 5 == 0:
            print(f"epoch {epoch:3d} RMSE {np.sqrt(losses[-1]):.4f}")
    print(f"final RMSE {np.sqrt(losses[-1]):.4f} ({dev})")
    return {"losses": losses, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
