"""GNN serving: sampled minibatch inference at fixed latency.

Twin of `examples/serving/serving_demo.py`: node features stay on the
card (`DeviceFeatureCache`, every row), a request is a set of node ids,
the C++ sampler builds its fanout blocks, `pad_block` pads them to
bucketed sizes, and an `InferenceSession` a bucket key (the first request
of a key builds it and is not timed) returns the logits of
`GraphSAGESampleModel` with bf16 inputs. Then `micro_demo`: single-node
requests from client threads share padded batches through
`serve.MicroBatcher` (buckets 8 and 32, 3 ms linger), one session a
bucket, each padded to the worst case of its fanouts. The same flags and
defaults, plus ``--device``.

    python -m gammagl_tpu_torch.examples.serving_demo --requests 50
    python -m gammagl_tpu_torch.examples.serving_demo --device cpu

The JAX demo submits its single-node requests from one thread; here
`MICRO_THREADS` client threads each send one request at a time and wait
for its answer, so each request's latency is measured.
"""

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from gammagl_tpu_torch.data.padding import size_bucket
from gammagl_tpu_torch.datasets import synthetic_community_graph
from gammagl_tpu_torch.loader import DeviceFeatureCache, NeighborSamplerLoader
from gammagl_tpu_torch.models import GraphSAGESampleModel
from gammagl_tpu_torch.serve import InferenceSession, MicroBatcher
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "BlockForward", "pad_block", "micro_pad_block",
           "main", "micro_demo"]

MICRO_BUCKETS, MICRO_LINGER_MS, MICRO_THREADS = (8, 32), 3.0, 8


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--fanout1", type=int, default=10)
    ap.add_argument("--fanout2", type=int, default=5)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--micro_requests", type=int, default=48,
                    help="0 disables the MicroBatcher phase")
    ap.add_argument("--n_epoch", type=int, default=1, help="unused; lets "
                    "the smoke runner pass a tiny epoch count")
    ap.add_argument("--device", default="cuda")
    return ap


class BlockForward(nn.Module):
    """``model`` over edge blocks whose destination sizes are fixed (one
    bucket's): ``forward(feats, *blocks)``, the inputs an
    `InferenceSession` places."""

    def __init__(self, model, sizes):
        super().__init__()
        self.model = model
        self.sizes = tuple(sizes)

    def forward(self, feats, *blocks):
        return self.model(feats, list(zip(blocks, self.sizes)))


def pad_block(bs, n_id, adjs):
    """Bucketed buffers of a sample (the sampled trainers' protocol:
    padded edges point their destination at the bucketed size_dst)."""
    n_pad = int(size_bucket(len(n_id) + 1))
    n_id_p = np.full(n_pad, n_id[-1], dtype=n_id.dtype)
    n_id_p[:len(n_id)] = n_id
    blocks, sizes = [], []
    for i, a in enumerate(adjs):
        size_dst = (int(bs) if i == len(adjs) - 1
                    else int(size_bucket(int(a.size[1]))))
        e_pad = int(size_bucket(int(a.edge_index.shape[1])))
        eb = np.full((2, e_pad), size_dst, dtype=np.int64)
        eb[:, :a.edge_index.shape[1]] = a.edge_index
        blocks.append(eb)
        sizes.append(size_dst)
    return n_id_p, blocks, tuple(sizes)


def micro_pad_block(bs, n_id, adjs, fanouts):
    """Buffers padded to the worst case of ``fanouts`` for ``bs`` seeds:
    one session a seed bucket (a fresh `size_bucket` key would build a
    session on the request path)."""
    tot, prefix = 1, 1
    for f in fanouts:
        prefix *= f
        tot += prefix
    n_cap = int(size_bucket(bs * tot + 1))
    e_cap = int(size_bucket(bs * (tot - 1)))
    n_id_p = np.full(n_cap, n_id[-1], dtype=n_id.dtype)
    n_id_p[:len(n_id)] = n_id
    blocks, sizes = [], []
    for i, a in enumerate(adjs):
        size_dst = int(bs) if i == len(adjs) - 1 else n_cap
        eb = np.full((2, e_cap), size_dst, dtype=np.int64)
        eb[:, :a.edge_index.shape[1]] = a.edge_index
        blocks.append(eb)
        sizes.append(size_dst)
    return n_id_p, blocks, tuple(sizes)


class _Sessions:
    """One `InferenceSession` a bucket key, built at the key's first
    request."""

    def __init__(self, model, device, compute_dtype):
        self.model, self.device = model, device
        self.compute_dtype = compute_dtype
        self.by_key = {}

    def __call__(self, feats, blocks, sizes):
        """(logits, whether this call built the session)."""
        key = (len(feats),) + tuple(b.shape[1] for b in blocks) + sizes
        blocks = [torch.from_numpy(b).to(self.device, non_blocking=True)
                  for b in blocks]
        built = key not in self.by_key
        if built:
            self.by_key[key] = InferenceSession(
                BlockForward(self.model, sizes), (feats, *blocks),
                device=self.device, compute_dtype=self.compute_dtype)
        return self.by_key[key](feats, *blocks), built


def main(args, data=None, params=None, compute_dtype=torch.bfloat16):
    """Serve ``args.requests`` requests of ``args.batch`` seeds, then the
    MicroBatcher phase. ``data``: (Graph, num_classes) (None: the JAX
    demo's synthetic graph of ``args.nodes`` nodes, ``args.feat``
    features, 8 classes); ``params``: a flax-shaped tree (None: the
    model's own init, seed 0); ``compute_dtype``: the inputs' dtype on the
    card (None: float32). Returns {"lat_ms", "sessions", "records",
    "micro", "model"}: the timed requests' ms, the sessions built, each
    timed request's (n_id_p, blocks, sizes, logits), what `micro_demo`
    returns, and the model served."""
    dev = resolve_device(args.device)
    if data is None:
        data = (synthetic_community_graph(args.nodes, 8, args.feat,
                                          avg_degree=10, seed=0), 8)
    g, num_classes = data
    n = g.num_nodes
    loader = NeighborSamplerLoader(
        np.asarray(g.edge_index), node_idx=np.arange(n),
        sample_lists=[args.fanout1, args.fanout2],
        batch_size=args.batch, num_nodes=n, seed=0)
    fcache = DeviceFeatureCache(np.asarray(g.x), budget_rows=n, device=dev)
    torch.manual_seed(0)
    model = GraphSAGESampleModel(hidden_dim=64, num_class=num_classes,
                                 num_layers=2, drop_rate=0.0,
                                 in_channels=np.asarray(g.x).shape[1])
    if params is not None:
        load_jax_params(model, params)
    sessions = _Sessions(model.to(dev), dev, compute_dtype)

    rng = np.random.default_rng(0)
    lat, records = [], []
    for _ in range(args.requests):
        seeds = rng.choice(n, args.batch, replace=False)
        t0 = time.perf_counter()
        bs, n_id, adjs = loader.sample(seeds)
        n_id_p, blocks, sizes = pad_block(bs, n_id, adjs)
        feats = fcache[n_id_p]
        logits, built = sessions(feats, blocks, sizes)
        if built:
            continue  # the request that builds a session is not timed
        logits = logits.cpu()  # syncs
        lat.append((time.perf_counter() - t0) * 1e3)
        records.append((n_id_p, blocks, sizes, logits))
    lat = np.asarray(lat)
    if len(lat):
        s = np.sort(lat)
        print(f"{len(lat)} requests, {len(sessions.by_key)} bucket "
              f"sessions: p50 {s[len(s) // 2]:.1f} ms  p95 "
              f"{s[int(len(s) * 0.95)]:.1f} ms  (sample + pad + cached gather "
              f"+ forward)")
    micro = (micro_demo(args, loader, fcache, model, dev, compute_dtype, n)
             if args.micro_requests else None)
    return {"lat_ms": lat, "sessions": len(sessions.by_key),
            "records": records, "micro": micro, "model": model}


def micro_demo(args, loader, fcache, model, dev, compute_dtype, n):
    """Online serving: ``args.micro_requests`` single-node requests from
    `MICRO_THREADS` client threads share padded batches through
    `MicroBatcher` (each request one seed id; the worker samples the
    union batch and splits the logits back). Returns {"lat_ms",
    "batches" (each run's (bucket, n_valid)), "outs", "wall_ms",
    "sessions"}."""
    sessions = _Sessions(model, dev, compute_dtype)
    fanouts = (args.fanout1, args.fanout2)
    batches = []

    def run(seed_batch, n_valid):
        seeds = np.asarray(seed_batch).reshape(-1)
        batches.append((len(seeds), n_valid))
        bs, n_id, adjs = loader.sample(seeds)
        n_id_p, blocks, sizes = micro_pad_block(bs, n_id, adjs, fanouts)
        logits, _ = sessions(fcache[n_id_p], blocks, sizes)
        return logits[:len(seeds)]

    rng = np.random.default_rng(1)
    with MicroBatcher(run, buckets=MICRO_BUCKETS,
                      linger_ms=MICRO_LINGER_MS) as mb:
        for b in MICRO_BUCKETS:  # the bucket sessions, off the clock
            run(rng.choice(n, b, replace=False), b)
        batches.clear()

        def request(seed):
            t0 = time.perf_counter()
            out = mb.submit(np.asarray([int(seed)])).result(timeout=120)
            return out, (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(MICRO_THREADS) as pool:
            done = list(pool.map(request, rng.choice(
                n, args.micro_requests, replace=False)))
        wall = time.perf_counter() - t0
    outs = [o for o, _ in done]
    lat = np.asarray([t for _, t in done])
    if not all(np.isfinite(o).all() for o in outs):
        raise RuntimeError("a micro-batched request returned non-finite "
                           "logits")
    s = np.sort(lat)
    print(f"micro-batched: {args.micro_requests} single-node requests "
          f"from {MICRO_THREADS} threads in {wall * 1e3:.0f} ms "
          f"({args.micro_requests / wall:.0f} req/s, buckets "
          f"{MICRO_BUCKETS}, {len(sessions.by_key)} sessions, "
          f"{len(batches)} batches); p50 {s[len(s) // 2]:.1f} ms, p95 "
          f"{s[int(len(s) * 0.95)]:.1f} ms")
    return {"lat_ms": lat, "batches": batches, "outs": outs,
            "wall_ms": wall * 1e3, "sessions": len(sessions.by_key)}


if __name__ == "__main__":
    main(parser().parse_args())
