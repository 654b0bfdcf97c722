"""DeFoG trainer: discrete flow matching on small synthetic graphs, then
Euler sampling.

Twin of `examples/defog/defog_trainer.py`: a `DeFoGModel` (2 layers; node
MLP 16, edge 8, global 16; dx 16, de 8, dy 16, 2 heads) on graphs of 8
nodes with 4 node and 3 edge classes (one-hot, symmetric edges, drawn
from ``np.random.default_rng(--seed)`` as the JAX script draws them);
each epoch a fresh graph, a time t ~ U[0, 1), the graph noised to t
(`flow_interpolate`) and one Adam step of ``--lr`` on the mean soft
cross-entropy of the node and edge logits against the clean one-hots;
then 10 Euler steps of dt 0.1 from uniform noise (`euler_sample_step`)
and the share of symmetric edge classes in the sample. The same flags,
plus ``--device``. Draws of t and of the noising come from a
`torch.Generator` seeded ``--seed + 1`` (the JAX script's keys differ:
ROADMAP C40), or from ``draws``.

    python -m gammagl_tpu_torch.examples.defog_trainer              # the card
    python -m gammagl_tpu_torch.examples.defog_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import base_parser
from gammagl_tpu_torch.models import (DeFoGModel, euler_sample_step,
                                      flow_interpolate)
from gammagl_tpu_torch.models.defog import flow_interpolate_apply
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "DIMS", "flow_loss"]

N_NODES = 8
DIMS = dict(n_layers=2,
            input_dims={"X": 4, "E": 3, "y": 1 + 64},
            hidden_mlp_dims={"X": 16, "E": 8, "y": 16},
            hidden_dims={"dx": 16, "de": 8, "dy": 16, "n_head": 2},
            output_dims={"X": 4, "E": 3, "y": 1})


def parser():
    return base_parser(__doc__.splitlines()[0], n_epoch=20, lr=0.001)


def flow_loss(model, Xt, Et, y, t, X1, E1):
    """Mean soft cross-entropy of the node and the edge logits against
    the clean one-hots."""
    pX, pE, _ = model(Xt, Et, y, t)
    lx = -(X1 * F.log_softmax(pX, -1)).sum(-1).mean()
    le = -(E1 * F.log_softmax(pE, -1)).sum(-1).mean()
    return lx + le


def main(args, params=None, draws=None):
    """Train and sample; returns {"losses", "validity", "state"}.
    ``params``: a flax tree for `load_jax_params` (None: its own init).
    ``draws``: an iterator giving, each epoch, (t, the noising's draws as
    `models.defog.flow_draws` returns them), else drawn here."""
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    n = N_NODES

    def sample_graph():
        X = F.one_hot(torch.from_numpy(rng.integers(0, 4, n)), 4).float()
        e = rng.integers(0, 3, (n, n))
        e = np.triu(e) + np.triu(e, 1).T
        E = F.one_hot(torch.from_numpy(e), 3).float()
        return X.to(dev), E.to(dev)

    sample_graph()  # the JAX script's init graph
    y = torch.zeros(1, device=dev)
    torch.manual_seed(args.seed)
    model = DeFoGModel(**DIMS)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    for epoch in range(args.n_epoch):
        X1, E1 = sample_graph()
        if draws is not None:
            t, d = next(draws)
            t = torch.as_tensor(t, dtype=torch.float32, device=dev)
            Xt, Et = flow_interpolate_apply(
                {k: torch.as_tensor(v, device=dev) for k, v in d.items()},
                X1, E1)
        else:
            t = torch.rand((), generator=gen, device=dev)
            Xt, Et = flow_interpolate(gen, X1, E1, t)
        model.train()
        loss = flow_loss(model, Xt, Et, y, t, X1, E1)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 5 == 0:
            print(f"epoch {epoch:3d} flow-matching loss {losses[-1]:.4f}")

    # Euler sampling from uniform noise
    Xt = F.one_hot(torch.randint(0, 4, (n,), generator=gen, device=dev),
                   4).float()
    Et = F.one_hot(torch.randint(0, 3, (n, n), generator=gen, device=dev),
                   3).float()
    model.eval()
    t = 0.0
    with torch.no_grad():
        for _ in range(10):
            pX, pE, _ = model(Xt, Et, y, torch.tensor(t, device=dev))
            Xt, Et = euler_sample_step(gen, Xt, Et, pX, pE, t, 0.1)
            t += 0.1
    print("sampled graph: node classes", Xt.argmax(-1).cpu().numpy())
    e_cls = Et.argmax(-1).cpu().numpy()
    validity = float((e_cls == e_cls.T).mean())
    print(f"sampled-graph symmetry validity {validity:.4f} ({dev})")
    return {"losses": losses, "validity": validity, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
