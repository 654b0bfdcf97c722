"""GraphSAGE on sampled blocks: minibatch training on Reddit's protocol.

Twin of `examples/graphsage/sage_sample_trainer.py` (reference:
examples/graphsage/reddit_sage_trainer.py): the C++ sampler's
`NeighborSamplerLoader` (fanouts 25 and 10, 512 seeds a batch) draws each
batch's blocks, `pad_batch_ids` pads them to bucketed sizes, the
`DeviceFeatureCache` gathers the features on the card, and Adam steps
`GraphSAGESampleModel` (mean aggregation: its blocks take no plan, as in
JAX, so the sums are the port's COO ops) on the cross-entropy of the
seeds; then the sampled test protocol. The same flags and defaults, plus
``--device``.

    python -m gammagl_tpu_torch.examples.sage_sample_trainer        # card
    python -m gammagl_tpu_torch.examples.sage_sample_trainer --device cpu

The graph is Reddit from ``--dataset_path``'s staged files
(``raw/reddit_data.npz``, ``raw/reddit_graph.npz``); without them the
twin prints JAX's warning and trains on the synthetic community graph
(5,000 nodes, 16 classes, 64 features). Nothing is fetched.
``--device_cache`` keeps every row on the card (0: none), ``--prefetch``
runs sampling and padding in a background thread (`loader.pipeline`),
``--resample_every`` k > 1 replays each sampled epoch k - 1 times
(`EpochCache`), ``--presample_chunks`` samples that many batches a call
on the sampler's OpenMP threads. Dropout draws from a generator on the
device, seeded from ``--seed``.
"""

import time

import numpy as np
import torch
import torch.nn.functional as F

from gammagl_tpu_torch.data.padding import size_bucket
from gammagl_tpu_torch.datasets import Reddit, synthetic_community_graph
from gammagl_tpu_torch.examples.common import base_parser, staged_dataset
from gammagl_tpu_torch.loader import (DeviceFeatureCache, EpochCache,
                                      NeighborSamplerLoader, pipeline)
from gammagl_tpu_torch.models import GraphSAGESampleModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import degree, load_jax_params, resolve_device

__all__ = ["parser", "load", "pad_batch_ids", "device_batch", "loss_of",
           "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=64, n_epoch=3,
                    lr=0.003)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--fanout1", type=int, default=25)
    p.add_argument("--fanout2", type=int, default=10)
    p.add_argument("--device_cache", type=int, default=1)
    p.add_argument("--prefetch", type=int, default=0)
    p.add_argument("--presample_chunks", type=int, default=4)
    p.add_argument("--resample_every", type=int, default=1)
    return p


def load(args):
    """(Graph, num_classes): Reddit from ``args.dataset_path``'s staged
    files, else the synthetic fallback with JAX's warning line."""
    try:
        g = staged_dataset(Reddit, args.dataset_path)[0]
        return g, int(np.asarray(g.y).max()) + 1
    except Exception as e:  # any failure to read: the JAX script's fallback
        print(f"[warn] reddit unavailable ({e}); synthetic graph")
        g = synthetic_community_graph(5000, 16, 64, avg_degree=12, seed=0)
        return g, 16


def pad_batch_ids(bs, n_id, adjs):
    """Bucket-padded blocks (so a batch's shapes come from a few buckets):
    padded edges point their destination at the (bucketed) size_dst,
    which the sums drop; padded node ids repeat the last real id."""
    n_pad = size_bucket(len(n_id))
    n_id_p = np.full(n_pad, n_id[-1], dtype=n_id.dtype)
    n_id_p[:len(n_id)] = n_id
    eis, sizes = [], []
    for i, a in enumerate(adjs):
        size_dst = (int(bs) if i == len(adjs) - 1
                    else int(size_bucket(int(a.size[1]))))
        e_pad = int(size_bucket(int(a.edge_index.shape[1])))
        ei = np.full((2, e_pad), size_dst, dtype=np.int64)
        ei[:, :a.edge_index.shape[1]] = a.edge_index
        eis.append(ei)
        sizes.append(size_dst)
    return n_id_p, eis, tuple(sizes)


def device_batch(bs, n_id, adjs, fcache, y_all):
    """A sampled batch on the cache's device: (features, edge blocks,
    destination sizes, the seeds' labels)."""
    n_id_p, eis, sizes = pad_batch_ids(bs, n_id, adjs)
    dev = fcache.device
    return (fcache[n_id_p],
            [torch.from_numpy(e).to(dev, non_blocking=True) for e in eis],
            sizes, torch.from_numpy(y_all[n_id[:bs]]).to(dev))


def loss_of(model, feats, eis, sizes, y, generator=None):
    """Mean cross-entropy of the seeds' logits, and the logits."""
    logits = model(feats, list(zip(eis, sizes)), generator=generator)
    return F.cross_entropy(logits.float(), y), logits


def _loader(graph, node_idx, args, shuffle, presample_chunks=1):
    return NeighborSamplerLoader(
        np.asarray(graph.edge_index), node_idx=node_idx,
        sample_lists=[args.fanout1, args.fanout2],
        batch_size=args.batch_size, num_nodes=graph.num_nodes,
        shuffle=shuffle, seed=args.seed, presample_chunks=presample_chunks)


def main(args, data=None, params=None, steps=None):
    """Train and score; returns {"losses", "batch_ms", "step_ms",
    "test_acc", "state", "cache"}: each step's loss, the host ms to have
    its batch (sampling, padding, the feature gather) and the ms of the
    step itself (ends in a sync). ``data``: (Graph, num_classes) (None:
    `load`); ``params``: a flax-shaped tree for `load_jax_params` (None:
    the model's own init from ``args.seed``); ``steps``: stop training
    after that many steps."""
    dev = resolve_device(args.device)
    graph, num_classes = data if data is not None else load(args)
    x_all = np.asarray(graph.x, np.float32)
    y_all = np.asarray(graph.y).astype(np.int64)
    train_idx = np.nonzero(np.asarray(graph.train_mask))[0]
    loader = _loader(graph, train_idx, args, True, args.presample_chunks)
    if args.resample_every > 1:
        loader = EpochCache(loader, resample_every=args.resample_every,
                            seed=args.seed)
    torch.manual_seed(args.seed)
    model = GraphSAGESampleModel(hidden_dim=args.hidden_dim,
                                 num_class=num_classes, num_layers=2,
                                 drop_rate=args.drop_rate,
                                 in_channels=x_all.shape[1])
    # the JAX script initialises from one sample of the loader's sampler:
    # drawing it here too keeps the sampler's stream, and so every batch,
    # the same
    loader.sample(train_idx[:args.batch_size])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    deg = degree(np.asarray(graph.edge_index)[1], graph.num_nodes)
    fcache = DeviceFeatureCache(x_all, budget_rows=graph.num_nodes
                                if args.device_cache else 0, score=deg,
                                device=dev)

    def device_batches():
        for bs, n_id, adjs in loader:
            if bs < args.batch_size:
                continue
            yield device_batch(bs, n_id, adjs, fcache, y_all)

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses, batch_ms, step_ms = [], [], []
    for epoch in range(args.n_epoch):
        t0 = time.time()
        correct = tot = 0
        it = device_batches()
        if args.prefetch:
            it = pipeline(it, size=2)
        t_batch = time.perf_counter()
        for feats, eis, sizes, y in it:
            t_step = time.perf_counter()
            model.train()
            loss, logits = loss_of(model, feats, eis, sizes, y, gen)
            loss.backward()
            state.apply_gradients()
            losses.append(float(loss.detach()))  # syncs
            correct += int((logits.argmax(-1) == y).sum())
            tot += int(y.shape[0])
            t_end = time.perf_counter()
            batch_ms.append((t_step - t_batch) * 1e3)
            step_ms.append((t_end - t_step) * 1e3)
            t_batch = t_end
            if steps is not None and len(losses) == steps:
                break
        n = max(len(losses), 1)
        print(f"epoch {epoch} loss {sum(losses) / n:.4f} train acc "
              f"{correct / max(tot, 1):.4f} ({time.time() - t0:.1f}s, cache "
              f"hit {fcache.hits}/{fcache.hits + fcache.misses})",
              flush=True)
        if steps is not None and len(losses) == steps:
            break

    # the sampled test protocol (reference reddit_sage_trainer.py): a fresh
    # sampler over the test seeds, no dropout
    test_idx = (np.nonzero(np.asarray(graph.test_mask))[0]
                if "test_mask" in graph.keys() else train_idx)
    model.eval()
    correct = total = 0
    with torch.no_grad():
        for bs, n_id, adjs in _loader(graph, test_idx, args, False):
            if len(n_id) == 0:
                continue
            feats, eis, sizes, _ = device_batch(bs, n_id, adjs, fcache,
                                                y_all)
            logits = model(feats, list(zip(eis, sizes)))
            pred = logits.argmax(-1)[:bs].cpu().numpy()
            correct += int((pred == y_all[n_id[:bs]]).sum())
            total += int(bs)
    acc = correct / max(total, 1)
    print(f"test acc {acc:.4f} ({total} nodes)")
    return {"losses": losses, "batch_ms": batch_ms, "step_ms": step_ms,
            "test_acc": acc, "state": state, "cache": fcache}


if __name__ == "__main__":
    main(parser().parse_args())
