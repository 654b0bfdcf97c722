"""GEN trainer: graph structure estimation by expectation maximisation.

Twin of `examples/gen/gen_trainer.py`: ``--iters`` rounds, each
``--n_epoch`` steps of Adam (a fresh optimizer a round, the parameters
carried over) of a `GCNModel` (no dropout) on the current graph; then
`GEstimationN` re-estimates the structure from two observations, the
current graph and the 5-nearest-neighbour graph of the features (inner
products), with the model's predictions (`GEstimationN.em`, seeded
``--seed``), and the pairs whose posterior passes ``--q_threshold``
become the next graph. The same flags, plus ``--device``. COO on every
device, as in JAX.

    python -m gammagl_tpu_torch.examples.gen_trainer              # the card
    python -m gammagl_tpu_torch.examples.gen_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import GCNModel, GEstimationN
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=30,
                       lr=0.01, iters=2, q_threshold=0.9)


def main(args, data=None, params=None):
    """Train; returns {"losses" (every step of every round), "edges" (the
    estimated graph's size a round), "best_test", "state"}. ``data`` and
    ``params`` as in `common.run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    n = x.shape[0]
    torch.manual_seed(args.seed)
    model = GCNModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     drop_rate=0.0)
    if params is not None:
        load_jax_params(model, params)
    model.to(dev)
    train_idx = np.nonzero(d["train_mask"].cpu().numpy())[0]
    estimator = GEstimationN(n, int(np.asarray(data["y"]).max()) + 1,
                             ei.cpu().numpy(), d["y"].cpu().numpy(),
                             train_idx)
    xf = x.cpu().numpy()
    nn_idx = np.argsort(-(xf @ xf.T), axis=1)[:, 1:6]
    knn = np.zeros((n, n), np.int64)
    knn[np.repeat(np.arange(n), 5), nn_idx.reshape(-1)] = 1
    cur_ei = ei
    losses, edges, best = [], [], 0.0
    for it in range(args.iters):
        state = TrainState(model, args.lr)
        for _ in range(args.n_epoch):
            model.train()
            loss = semi_supervised_loss(model(x, cur_ei), d["y"],
                                        d["train_mask"])
            loss.backward()
            state.apply_gradients()
            losses.append(float(loss.detach()))
        logits = predict(model, x, cur_ei)
        acc = float(accuracy(logits, d["y"], d["test_mask"]))
        best = max(best, acc)
        print(f"iter {it}: test acc {acc:.4f}")
        # EM re-estimation: observations = current graph + kNN graph
        pred = logits.argmax(1).cpu().numpy()
        estimator.reset_obs()
        adj = np.zeros((n, n), np.int64)
        cur = cur_ei.cpu().numpy()
        adj[cur[0], cur[1]] = 1
        estimator.update_obs(adj)
        estimator.update_obs(knn)
        _, _, _, Q, iters = estimator.em(pred, seed=args.seed)
        new = np.stack(np.nonzero(Q > args.q_threshold))
        if new.shape[1] > 0:
            cur_ei = torch.from_numpy(new).to(dev)
        edges.append(int(new.shape[1]))
        print(f"  EM {iters} iters, {new.shape[1]} edges")
    print(f"best test acc {best:.4f} ({dev})")
    return {"losses": losses, "edges": edges, "best_test": best,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
