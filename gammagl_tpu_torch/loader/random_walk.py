"""Random walks and the node2vec-style positive / negative batch loader
(counterpart of `gammagl_tpu/loader/random_walk.py`).

Reference: gammagl/loader/random_walk_sampler.py:8, gammagl/utils/
random_walk_sample.py:16, gammagl/ops/sparse/cpu/rw.cpp:1-58. The walks
are numpy's, uniform (p = q = 1) or node2vec-biased, drawn from the
caller's ``default_rng`` as the JAX package draws them; the C++ sampler's
uniform walk is `csrc.random_walk_c`.
"""

import numpy as np

from gammagl_tpu_torch.ops.sparse import ind2ptr_np

__all__ = ["random_walk", "RandomWalkLoader"]


def random_walk(edge_index, num_nodes, start, walk_length, p=1.0, q=1.0,
                rng=None):
    """Uniform (p=q=1) or node2vec-biased walks over the CSR.

    Returns (len(start), walk_length+1) node ids; a walk that reaches a
    node without out-edges stays there.
    """
    rng = rng or np.random.default_rng()
    ei = np.asarray(edge_index)
    order = np.argsort(ei[0], kind="stable")
    rowptr = ind2ptr_np(ei[0][order], num_nodes)
    col = ei[1][order]
    start = np.asarray(start)
    walks = np.empty((len(start), walk_length + 1), dtype=np.int64)
    walks[:, 0] = start
    for i, s in enumerate(start):
        prev = -1
        cur = int(s)
        for t in range(1, walk_length + 1):
            lo, hi = rowptr[cur], rowptr[cur + 1]
            if hi == lo:
                walks[i, t:] = cur
                break
            if p == 1.0 and q == 1.0 or prev < 0:
                nxt = int(col[rng.integers(lo, hi)])
            else:
                nbrs = col[lo:hi]
                w = np.where(nbrs == prev, 1.0 / p,
                             np.where(np.isin(
                                 nbrs, col[rowptr[prev]:rowptr[prev + 1]]),
                                 1.0, 1.0 / q))
                nxt = int(rng.choice(nbrs, p=w / w.sum()))
            walks[i, t] = nxt
            prev, cur = cur, nxt
    return walks


class RandomWalkLoader:
    """Yields (pos_walks, neg_samples) batches for skip-gram embedding
    training (reference random_walk_sampler.py)."""

    def __init__(self, edge_index, num_nodes, batch_size=128,
                 walk_length=10, num_negatives=1, p=1.0, q=1.0,
                 shuffle=True, seed=None):
        self.edge_index = np.asarray(edge_index)
        self.num_nodes = num_nodes
        self.batch_size = batch_size
        self.walk_length = walk_length
        self.num_negatives = num_negatives
        self.p, self.q = p, q
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return -(-self.num_nodes // self.batch_size)

    def __iter__(self):
        order = np.arange(self.num_nodes)
        if self.shuffle:
            self.rng.shuffle(order)
        for lo in range(0, self.num_nodes, self.batch_size):
            start = order[lo:lo + self.batch_size]
            pos = random_walk(self.edge_index, self.num_nodes, start,
                              self.walk_length, self.p, self.q, self.rng)
            neg = self.rng.integers(
                0, self.num_nodes,
                (len(start), self.num_negatives, self.walk_length + 1))
            yield pos, neg
