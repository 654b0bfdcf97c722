"""SEAL trainer: link prediction by DGCNN over DRNL-labeled enclosing
subgraphs, scored by AUC.

Twin of `examples/seal/seal_trainer.py`: each epoch a batch of
``--batch_size`` links, true edges and random pairs in turn (drawn from
``np.random.default_rng(--seed)`` in the JAX script's order), each link's
1-hop enclosing subgraph (the two ends and up to 8 neighbours of each)
labeled by `drnl_node_labeling`, batched and padded to fixed sizes (24
nodes and 160 edges a link; padded nodes in graph ``batch_size``, out of
range, padded edges a self-loop of the last row); a `SEALModel`
(``--hidden_dim``, k 6) takes one Adam step of ``--lr`` on the binary
cross-entropy of its logits; then the AUC of 8 fresh batches
(`common.binary_auc`). One batch is drawn before the loop, as the JAX
script draws it for ``init``. The same flags, plus ``--device``. COO on
every device, as in JAX.

    python -m gammagl_tpu_torch.examples.seal_trainer              # the card
    python -m gammagl_tpu_torch.examples.seal_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import (base_parser, binary_auc,
                                               node_data)
from gammagl_tpu_torch.models import SEALModel, drnl_node_labeling
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "subgraph_batch"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=5,
                       lr=0.005, batch_size=16)


def subgraph_batch(ei, n, rng, batch_size):
    """The JAX script's batch, numpy: (labels, edge_index, batch, y,
    num_graphs) of ``batch_size`` DRNL-labeled enclosing subgraphs,
    padded to ``24 * batch_size`` nodes and ``160 * batch_size`` edges."""
    xs, eis, batch, ys = [], [], [], []
    off = 0
    adj = [set() for _ in range(n)]
    for s, d in ei.T:
        adj[s].add(int(d))
        adj[d].add(int(s))
    for i in range(batch_size):
        if i % 2 == 0:
            e = ei[:, rng.integers(0, ei.shape[1])]
        else:
            e = rng.integers(0, n, 2)
        u, v = int(e[0]), int(e[1])
        nodes = sorted({u, v} | set(list(adj[u])[:8])
                       | set(list(adj[v])[:8]))
        local = {m: j for j, m in enumerate(nodes)}
        sub = [(local[a], local[b]) for a in nodes
               for b in adj[a] if b in local]
        sub_ei = (np.asarray(sub).T if sub
                  else np.zeros((2, 0), np.int64))
        labels = drnl_node_labeling(sub_ei, len(nodes), local[u], local[v])
        xs.append(labels)
        eis.append(sub_ei + off)
        batch.extend([i] * len(nodes))
        ys.append(1 - i % 2)
        off += len(nodes)
    node_cap, edge_cap = batch_size * 24, batch_size * 160
    labels_cat = np.concatenate(xs)[:node_cap]
    ei_cat = np.concatenate(eis, axis=1)
    ei_cat = ei_cat[:, (ei_cat < node_cap).all(0)][:, :edge_cap]
    batch_cat = np.asarray(batch)[:node_cap]
    pad_n = node_cap - len(labels_cat)
    pad_e = edge_cap - ei_cat.shape[1]
    labels_cat = np.concatenate(
        [labels_cat, np.zeros(pad_n, labels_cat.dtype)])
    batch_cat = np.concatenate(
        [batch_cat, np.full(pad_n, batch_size, batch_cat.dtype)])
    ei_cat = np.concatenate(
        [ei_cat, np.full((2, pad_e), node_cap - 1, ei_cat.dtype)], axis=1)
    return labels_cat, ei_cat, batch_cat, np.asarray(ys), batch_size


def main(args, data=None, params=None):
    """Train and score; returns {"losses", "auc", "state"}. ``data`` and
    ``params`` as in `common.run_simple_node_trainer`."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    ei = np.asarray(data["edge_index"])
    n = data["x"].shape[0]
    rng = np.random.default_rng(args.seed)

    def draw():
        lab, sei, b, y, ng = subgraph_batch(ei, n, rng, args.batch_size)
        return (*(torch.from_numpy(a).to(dev) for a in (lab, sei, b, y)),
                ng)

    draw()  # the JAX script's init batch
    torch.manual_seed(args.seed)
    model = SEALModel(hidden_dim=args.hidden_dim, k=6)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        labels, sei, batch, y, ng = draw()
        model.train()
        logits = model(labels, sei, None, batch, ng)
        loss = F.binary_cross_entropy_with_logits(logits[:, 0], y.float())
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        print(f"epoch {epoch:3d} loss {losses[-1]:.4f}")
    scores, ys = [], []
    model.eval()
    with torch.no_grad():
        for _ in range(8):
            labels, sei, batch, y, ng = draw()
            scores.append(model(labels, sei, None, batch,
                                ng)[:, 0].cpu().numpy())
            ys.append(y.cpu().numpy())
    auc = binary_auc(np.concatenate(scores), np.concatenate(ys))
    print(f"link-pred AUC {auc:.4f} ({dev})")
    return {"losses": losses, "auc": auc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
