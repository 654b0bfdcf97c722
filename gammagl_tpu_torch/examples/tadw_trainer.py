"""TADW trainer: text-associated DeepWalk by gradient steps on a
low-rank factorisation, then a linear probe on the embeddings.

Twin of `examples/tadw/tadw_trainer.py`: the same inputs (the dense
adjacency of the loaded graph, its features as the text, reduced to 200
dimensions by an SVD where wider, in host numpy), the same model (`tadw`,
``--hidden_dim`` dimensions, ``--n_epoch`` steps, JAX's numpy draws), the
same probe (`linear_probe`) and the same flags, plus ``--device``, where
the steps run.

    python -m gammagl_tpu_torch.examples.tadw_trainer              # the card
    python -m gammagl_tpu_torch.examples.tadw_trainer --device cpu
"""

import time

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               linear_probe, node_data)
from gammagl_tpu_torch.models import tadw
from gammagl_tpu_torch.utils import resolve_device

__all__ = ["parser", "main", "inputs"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=80, n_epoch=20)


def inputs(data):
    """The JAX script's (adjacency, text): adj[src, dst] = 1 over the
    graph's edges (no self-loops added), the features reduced to their
    first 200 singular directions (u s) where wider."""
    n = data["x"].shape[0]
    adj = np.zeros((n, n), np.float32)
    ei = np.asarray(data["edge_index"])
    adj[ei[0], ei[1]] = 1.0
    text = np.asarray(data["x"], np.float32)
    if text.shape[1] > 200:
        u, s, _ = np.linalg.svd(text, full_matrices=False)
        text = u[:, :200] * s[:200]
    return adj, text


def main(args, data=None):
    """Factorise and probe; returns {"embedding", "probe_acc", "seconds"}
    (the factorisation's wall seconds, the host's input build included)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    num_classes = int(np.asarray(data["y"]).max()) + 1
    t0 = time.perf_counter()
    adj, text = inputs(data)
    emb = tadw(adj, text, dim=args.hidden_dim, iters=args.n_epoch,
               device=dev)
    seconds = time.perf_counter() - t0
    acc = linear_probe(torch.from_numpy(emb).to(dev),
                       device_graph(data, dev), num_classes)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"embedding": emb, "probe_acc": acc, "seconds": seconds}


if __name__ == "__main__":
    main(parser().parse_args())
