"""Negative edge sampling (counterpart of
`gammagl_tpu/utils/negative_sampling.py`; reference:
gammagl/utils/negative_sampling.py:9).

Edges are encoded as flat ids ``src * num_nodes + dst`` and ids not in
the positive set are drawn by rejection, in numpy on the host (the loop
runs a data-dependent number of rounds). The draws are the JAX package's
numpy stream: the same ``rng`` gives the same edges. ``rng=None`` takes
an unseeded ``np.random.default_rng()``.
"""

import numpy as np

__all__ = ["negative_sampling", "batched_negative_sampling",
           "structured_negative_sampling"]


def _edge_ids(edge_index, num_nodes):
    return (edge_index[0].astype(np.int64) * num_nodes
            + edge_index[1].astype(np.int64))


def negative_sampling(edge_index, num_nodes=None, num_neg_samples=None,
                      method="sparse", force_undirected=False, rng=None):
    """Sample non-edges uniformly; returns (2, num_neg) int array."""
    ei = np.asarray(edge_index)
    rng = rng or np.random.default_rng()
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1 if ei.size else 0
    if num_neg_samples is None:
        num_neg_samples = ei.shape[1]
    pos = set(_edge_ids(ei, num_nodes).tolist())
    if force_undirected:
        pos |= set(_edge_ids(ei[::-1], num_nodes).tolist())
    out = np.empty(num_neg_samples, dtype=np.int64)
    filled = 0
    max_id = num_nodes * num_nodes
    while filled < num_neg_samples:
        cand = rng.integers(0, max_id, size=2 * (num_neg_samples - filled))
        # reject self-loops and positives
        keep = cand[(cand // num_nodes != cand % num_nodes)]
        keep = np.array([c for c in keep if c not in pos], dtype=np.int64)
        take = min(len(keep), num_neg_samples - filled)
        out[filled:filled + take] = keep[:take]
        filled += take
    return np.stack([out // num_nodes, out % num_nodes]).astype(ei.dtype)


def batched_negative_sampling(edge_index, batch, num_neg_samples=None,
                              rng=None):
    """Negative sampling constrained within each graph of a batch."""
    ei = np.asarray(edge_index)
    batch = np.asarray(batch)
    rng = rng or np.random.default_rng()
    edge_batch = batch[ei[0]]
    outs = []
    for b in np.unique(edge_batch):
        nodes = np.nonzero(batch == b)[0]
        lo, hi = nodes.min(), nodes.max() + 1
        sub = ei[:, edge_batch == b] - lo
        neg = negative_sampling(sub, num_nodes=hi - lo,
                                num_neg_samples=num_neg_samples, rng=rng)
        outs.append(neg + lo)
    return np.concatenate(outs, axis=1)


def structured_negative_sampling(edge_index, num_nodes=None, rng=None):
    """For each positive (i, j) sample a k with (i, k) not an edge.

    Returns (i, j, k) index triple.
    """
    ei = np.asarray(edge_index)
    rng = rng or np.random.default_rng()
    if num_nodes is None:
        num_nodes = int(ei.max()) + 1 if ei.size else 0
    pos = set(_edge_ids(ei, num_nodes).tolist())
    k = rng.integers(0, num_nodes, size=ei.shape[1])
    for idx in range(ei.shape[1]):
        while (ei[0, idx] * num_nodes + k[idx]) in pos or k[idx] == ei[0, idx]:
            k[idx] = rng.integers(0, num_nodes)
    return ei[0], ei[1], k.astype(ei.dtype)
