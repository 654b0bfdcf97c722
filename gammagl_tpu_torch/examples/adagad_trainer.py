"""AdaGAD trainer: anomaly detection by masked reconstruction, scored by
the AUC against injected anomalies.

Twin of `examples/adagad/adagad_trainer.py`: the same injection (5% of
the nodes, at least 8, drawn from ``np.random.default_rng(--seed + 7)``:
half get features shifted by noise of 3 std, half are joined by a
random clique of 4 edges each), the same negatives (half as many as the
edges, `negative_sampling` from ``default_rng(--seed)``), the same model
(`AdaGADModel`, ``--hidden_dim``, latent 8), the same loop (``--n_epoch``
steps of Adam at ``--lr`` on the model's loss), the AUC of the
attribute-error scores (`binary_auc`) and the same flags, plus
``--device``. The model takes no plan, as in JAX: its sums are the
port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.adagad_trainer              # the card
    python -m gammagl_tpu_torch.examples.adagad_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, binary_auc,
                                               device_graph, node_data,
                                               predict)
from gammagl_tpu_torch.models import AdaGADModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import (load_jax_params, negative_sampling,
                                     resolve_device)

__all__ = ["parser", "main", "inject_anomalies"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=30,
                       lr=0.005)


def inject_anomalies(x, edge_index, seed):
    """The JAX script's injection on numpy arrays: (x with the contextual
    anomalies, edge_index with the cliques appended, the negatives, the
    (N,) anomaly labels)."""
    rng = np.random.default_rng(seed + 7)
    n = x.shape[0]
    n_anom = max(8, n // 20)
    anom = rng.choice(n, n_anom, replace=False)
    is_anom = np.zeros(n, bool)
    is_anom[anom] = True
    x = np.array(x, np.float32)
    x[anom[:n_anom // 2]] += rng.normal(
        scale=3.0 * x.std() + 1e-6, size=(n_anom // 2, x.shape[1])
    ).astype(x.dtype)
    clique = anom[n_anom // 2:]
    extra = np.stack([np.repeat(clique, 4), rng.choice(clique,
                                                       4 * len(clique))])
    ei = np.concatenate([np.asarray(edge_index), extra], axis=1)
    neg = negative_sampling(ei, num_nodes=n, num_neg_samples=ei.shape[1] // 2,
                            rng=np.random.default_rng(seed))
    return x, ei, neg, is_anom


def main(args, data=None, params=None):
    """Train and score; returns {"losses", "auc", "state"}. ``data`` and
    ``params`` as in `run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, torch.device("cpu"))
    x, ei, neg, is_anom = inject_anomalies(d["x"].numpy(),
                                           d["edge_index"].numpy(), args.seed)
    x, ei, neg = (torch.from_numpy(a).to(dev) for a in (x, ei, neg))
    model = AdaGADModel(hidden_dim=args.hidden_dim, latent_dim=8,
                        in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        loss = model(x, ei, neg)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 10 == 0:
            print(f"epoch {epoch:3d} recon loss {losses[-1]:.4f}")
    scores = predict(model, x, ei).cpu().numpy()
    auc = binary_auc(scores, is_anom)
    print(f"anomaly AUC {auc:.4f} ({dev})")
    return {"losses": losses, "auc": auc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
