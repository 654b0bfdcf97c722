"""Neighbour-sampler benchmark: the C++ sampler against the numpy route.

Twin of `examples/sampler/neighbor_sampler.py` (reference
examples/sampler/): GraphSAGE-style fanouts over a random graph, ms a
batch of `NeighborSampler.sample_from_nodes` with ``use_ext=True`` (the C++
sampler) and ``use_ext=False`` (numpy). Host work only; the same flags
and defaults.

    python -m gammagl_tpu_torch.examples.neighbor_sampler --num_nodes 100000
"""

import argparse
import time

import numpy as np

from gammagl_tpu_torch.sampler.neighbor_sampler import NeighborSampler

__all__ = ["parser", "main"]


def parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num_nodes", type=int, default=100_000)
    p.add_argument("--num_edges", type=int, default=1_000_000)
    p.add_argument("--fanouts", type=int, nargs="+", default=[25, 10])
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--iters", type=int, default=5)
    return p


def main(args):
    """Returns {route name: (ms a batch, nodes, edges of the last
    sample)}."""
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, args.num_nodes, args.num_edges),
                   rng.integers(0, args.num_nodes, args.num_edges)])
    out_by_route = {}
    for use_ext, name in ((True, "C++"), (False, "numpy")):
        sampler = NeighborSampler(ei, args.num_nodes, args.fanouts,
                                  seed=0, use_ext=use_ext)
        seeds = rng.integers(0, args.num_nodes, args.batch_size)
        sampler.sample_from_nodes(seeds)  # warm
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = sampler.sample_from_nodes(seeds)
        dt = (time.perf_counter() - t0) / args.iters
        print(f"{name:6s}: {dt * 1e3:8.2f} ms/batch "
              f"({len(out.node)} nodes, {len(out.row)} edges)")
        out_by_route[name] = (dt * 1e3, len(out.node), len(out.row))
    return out_by_route


if __name__ == "__main__":
    main(parser().parse_args())
