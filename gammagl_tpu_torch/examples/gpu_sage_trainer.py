"""GraphSAGE fed from the host sampler, a feature cache on the card and
prefetching.

Twin of `examples/gpu_sage/gpu_sage_trainer.py` (reference
examples/gpu_sage and gglspeedup): `NodeNeighborLoader` (fanouts 8 and 4)
samples each batch on the host, `PrefetchLoader` moves the next one to
the card on a side stream while the current step runs, the
`DeviceFeatureCache` holds the half of the rows with the highest degree
(the rest come from pinned host memory), and Adam steps `GraphSAGEModel`
on the masked cross-entropy of the padded subgraph (padded rows are
masked out). The same flags and defaults, plus ``--device``.

    python -m gammagl_tpu_torch.examples.gpu_sage_trainer            # card
    python -m gammagl_tpu_torch.examples.gpu_sage_trainer --device cpu
"""

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.data.padding import size_bucket
from gammagl_tpu_torch.examples.common import base_parser, load_node_dataset
from gammagl_tpu_torch.loader import (DeviceFeatureCache, NodeNeighborLoader,
                                      PrefetchLoader)
from gammagl_tpu_torch.models import GraphSAGEModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import degree, load_jax_params, resolve_device

__all__ = ["parser", "pad_batch", "masked_loss", "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=2,
                    lr=0.003)
    p.add_argument("--batch_size", type=int, default=64)
    return p


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def pad_batch(sub):
    """Bucket-padded subgraph (host arrays): node ids, edges, labels and
    the mask of real rows. Padded edges point at the last pad row, which
    is never a real node (n + 1 is bucketed), padded ids repeat the last
    real one."""
    n_id_sub = _host(sub.n_id)
    n, e = sub.num_nodes, sub.edge_index.shape[1]
    n_pad, e_pad = int(size_bucket(n + 1)), int(size_bucket(e))
    n_id = np.full(n_pad, n_id_sub[-1], np.int64)
    n_id[:n] = n_id_sub
    ei = np.full((2, e_pad), n_pad - 1, np.int64)
    ei[:, :e] = _host(sub.edge_index)
    y = np.zeros(n_pad, np.int64)
    y[:n] = _host(sub.y)
    mask = (np.arange(n_pad) < n).astype(np.float32)
    return n_id, ei, y, mask


def masked_loss(model, x, ei, y, mask):
    ls = F.cross_entropy(model(x, ei).float(), y, reduction="none")
    return (ls * mask).sum() / mask.sum().clamp_min(1.0)


def main(args, data=None, params=None, steps=None, on_batch=None):
    """Train; returns {"losses", "cache", "state"}: each step's loss.
    ``data``: (Graph, num_classes) (None: `load_node_dataset` of
    ``args.dataset``); ``params``: a flax-shaped tree for
    `load_jax_params` (None: the model's own init from ``args.seed``);
    ``steps``: stop after that many steps; ``on_batch(n_id, x)``, when
    given, sees each step's padded ids and the features the cache
    gathered for them."""
    dev = resolve_device(args.device)
    g, num_classes = (data if data is not None
                      else load_node_dataset(args.dataset, args.dataset_path))
    ei_all = np.asarray(g.edge_index)
    deg = degree(ei_all[1], g.num_nodes)
    cache = DeviceFeatureCache(np.asarray(g.x), budget_rows=g.num_nodes // 2,
                               score=deg, device=dev)
    loader = NodeNeighborLoader(g, num_neighbors=[8, 4],
                                batch_size=args.batch_size, shuffle=True,
                                seed=args.seed)
    torch.manual_seed(args.seed)
    model = GraphSAGEModel(hidden_dim=args.hidden_dim, num_class=num_classes,
                           drop_rate=0.0, in_channels=g.x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for epoch in range(args.n_epoch):
        for sub in PrefetchLoader(loader, size=2, device=dev):
            n_id, ei, y, mask = pad_batch(sub)
            x = cache[n_id]                     # hot rows on the card
            if on_batch is not None:
                on_batch(n_id, x)
            model.train()
            loss = masked_loss(model, x, torch.from_numpy(ei).to(dev),
                               torch.from_numpy(y).to(dev),
                               torch.from_numpy(mask).to(dev))
            loss.backward()
            state.apply_gradients()
            losses.append(float(loss.detach()))
            if steps is not None and len(losses) == steps:
                break
        print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
              f"cache hit-rate {cache.hit_rate:.2%}")
        if steps is not None and len(losses) == steps:
            break
    return {"losses": losses, "cache": cache, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
