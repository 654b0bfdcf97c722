"""The multi-process input pipeline, counterpart of
`gammagl_tpu/loader/multihost.py`.

On a TPU pod every host runs the same SPMD program, so the JAX loader (a)
gives each host a disjoint seed shard, (b) samples minibatches on the
host, (c) pads them to one static shape and (d) assembles global arrays
whose batch axis is sharded over the data-parallel mesh axis. The port
runs one process a part over ``torch.distributed``: (a)-(c) are the same
numpy, bit for bit, and (d) is this process's block of the global batch
as tensors on its device, since a process's view of JAX's global array is
its shard. Each process takes one shard a step (JAX's ``dp / process
count`` shards a host, with one device a process).
"""

import numpy as np

from gammagl_tpu_torch.loader.node_loader import filter_graph
from gammagl_tpu_torch.parallel.mesh import world
from gammagl_tpu_torch.utils.device import to_device

__all__ = ["shard_seeds", "make_global_batch", "MultiHostNodeLoader",
           "pad_sampled_graph"]


def shard_seeds(seeds, process_index=None, process_count=None,
                drop_remainder=True, group=None):
    """Disjoint, equal-length per-process seed shards: process i of P
    takes ``seeds[i * per:(i + 1) * per]`` with ``per = len // P``.

    Equal length is what keeps every process at the same number of steps
    (the collectives would deadlock otherwise): with ``drop_remainder``
    the tail of fewer than P seeds is dropped; without it the seeds are
    padded by repeating their head. The index and count default to this
    process's rank and the size of ``group`` (None: the default group, or
    this process alone)."""
    seeds = np.asarray(seeds)
    if process_index is None or process_count is None:
        rank, size, _ = world(group)
        pi = rank if process_index is None else process_index
        pc = size if process_count is None else process_count
    else:
        pi, pc = process_index, process_count
    per = len(seeds) // pc
    if per == 0:
        raise ValueError(
            f"{len(seeds)} seeds cannot be split across {pc} hosts")
    if not drop_remainder and len(seeds) % pc:
        per += 1
        pad = per * pc - len(seeds)
        seeds = np.concatenate([seeds, seeds[:pad]])
    return seeds[pi * per:(pi + 1) * per]


def make_global_batch(tree, device=None):
    """This process's block of the global batch: each numpy array of the
    tree (dicts, lists, tuples) as a tensor on ``device`` (None: the
    card). The JAX function assembles the hosts' blocks into one array
    sharded over a mesh; a process's view of it is its own block."""
    from gammagl_tpu_torch.serve import _tree_map
    return _tree_map(lambda x: to_device(np.asarray(x), device), tree)


def pad_sampled_graph(sub, num_nodes, num_edges, num_seeds):
    """Pad a sampled subgraph to static (num_nodes, num_edges) buckets.

    Padded edges point ``src = dst = num_nodes - 1``, the last padding
    row, never a seed (seeds are the first ``batch_size`` rows of a
    sampled block), so a masked reduce such as a segment max sees them
    only in a row nobody reads.

    Returns a dict of numpy arrays:
      x (num_nodes, F), y (num_nodes,), edge_index (2, num_edges),
      edge_mask (num_edges,), node_mask (num_nodes,), seed_mask
      (num_nodes,), n_id (num_nodes,)
    """
    n, e = sub.num_nodes, sub.edge_index.shape[1]
    if n > num_nodes or e > num_edges:
        raise ValueError(f"bucket too small: ({n},{e}) vs "
                         f"({num_nodes},{num_edges})")
    out = {}
    x = np.asarray(sub.x)
    out["x"] = np.pad(x, ((0, num_nodes - n),) + ((0, 0),) * (x.ndim - 1))
    if getattr(sub, "y", None) is not None:
        y = np.asarray(sub.y)
        out["y"] = np.pad(y, ((0, num_nodes - n),) + ((0, 0),) *
                          (y.ndim - 1))
    ei = np.asarray(sub.edge_index)
    pad_dst = num_nodes - 1  # a padding row unless the block is full
    ei_pad = np.full((2, num_edges - e), pad_dst, ei.dtype)
    out["edge_index"] = np.concatenate([ei, ei_pad], axis=1)
    out["edge_mask"] = (np.arange(num_edges) < e)
    out["node_mask"] = (np.arange(num_nodes) < n)
    seed = np.zeros(num_nodes, bool)
    seed[:sub.batch_size] = True
    out["seed_mask"] = seed
    out["n_id"] = np.pad(np.asarray(sub.n_id), (0, num_nodes - n),
                         constant_values=pad_dst)
    return out


class MultiHostNodeLoader:
    """Per-process neighbour-sampled minibatches, padded to static
    buckets, as this process's block of a global batch.

    Every process builds the loader with the SAME input_nodes and seed;
    each epoch shuffles them with ``default_rng(seed + epoch)`` (the same
    permutation everywhere), `shard_seeds` gives this process its
    disjoint shard, and each step samples ``batch_size`` of its seeds,
    pads them with `pad_sampled_graph` and yields a dict of tensors on
    ``device`` (None: the card) with a leading axis of 1 (its one shard
    of the global batch axis). ``process_index`` / ``process_count``
    default to the rank and size of ``group``.

    node_bucket / edge_bucket are the static padded shapes; None sizes
    them from the sampler's fanouts (``batch_size`` times their products,
    plus a tenth), as the JAX loader does.
    """

    def __init__(self, graph, sampler, input_nodes=None, batch_size=512,
                 node_bucket=None, edge_bucket=None, shuffle=True, seed=0,
                 process_index=None, process_count=None, group=None,
                 device=None):
        rank, size, _ = world(group)
        self.pi = rank if process_index is None else process_index
        self.pc = size if process_count is None else process_count
        if input_nodes is None:
            input_nodes = np.arange(graph.num_nodes)
        self.all_seeds = np.asarray(input_nodes)
        self.graph = graph
        self.sampler = sampler
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.device = device
        self.epoch = 0
        if node_bucket is None or edge_bucket is None:
            fan = getattr(sampler, "num_neighbors", [10, 10])
            est = batch_size
            tot, e_tot = est, 0
            for f in fan:
                est = est * max(int(f), 1)
                e_tot += est
                tot += est
            node_bucket = node_bucket or int(tot * 1.1) + 1
            edge_bucket = edge_bucket or int(e_tot * 1.1) + 1
        self.node_bucket = node_bucket
        self.edge_bucket = edge_bucket

    def __len__(self):
        return len(self.all_seeds) // self.pc // self.batch_size

    def __iter__(self):
        order = self.all_seeds.copy()
        if self.shuffle:
            # the same permutation in every process: epochs stay aligned
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        mine = shard_seeds(order, self.pi, self.pc)
        for s in range(len(mine) // self.batch_size):
            seeds = mine[s * self.batch_size:(s + 1) * self.batch_size]
            out = self.sampler.sample_from_nodes(seeds)
            shard = pad_sampled_graph(filter_graph(self.graph, out),
                                      self.node_bucket, self.edge_bucket,
                                      len(seeds))
            yield make_global_batch({k: v[None] for k, v in shard.items()},
                                    self.device)
