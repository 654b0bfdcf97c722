"""A citation graph with ogbn-papers100M's widths at a fraction of its
size, drawn on the device from a seed.

The law of the papers twin's synthetic shard (`synthetic_papers` in the
port's papers100M example), frozen here: 172 classes drawn uniformly;
each edge's destination uniform; its source, with probability 0.7
(homophily) a uniform node of the destination's class, else a zipf(1.35)
draw, minus one, modulo the node count, so low ids are hubs in the
reversed graph; features 0.5 N(0, 1) plus a random prototype of the
node's class. Every draw is a few large calls of a `torch.Generator`
on the device: the graph (classes and edges) from the configuration's
graph seed, so every run of a cell trains on one graph, as a deployment
does, and the features from the run's seed.
"""

import numpy as np
import torch

PAPERS_NODES, PAPERS_EDGES = 111_059_956, 1_615_685_872

# the zipf law's table: exact probabilities for k <= _ZIPF_TABLE, the
# tail above it drawn from the continuous law of the same exponent
_ZIPF_TABLE = 1 << 20


def zipf(gen, count, a, device):
    """``count`` draws of the zipf law P(k) ~ k^-a, k >= 1, as float64 (a
    draw may pass every integer type; the caller reduces it)."""
    # the table on the host: a scan on the card may add in another order
    # from run to run, and one seed has to give one graph
    pmf = np.arange(1, _ZIPF_TABLE + 1, dtype=np.float64) ** -a
    tail = (_ZIPF_TABLE + 0.5) ** (1 - a) / (a - 1)
    cdf = torch.from_numpy(np.cumsum(pmf) / (pmf.sum() + tail)).to(device)
    u = torch.rand(count, generator=gen, device=device, dtype=torch.float64)
    head = torch.searchsorted(cdf, u).to(torch.float64) + 1
    # above the table: P(X > x) ~ x^(1 - a), inverted from the tail share
    p_tail = 1.0 - float(cdf[-1])
    v = ((u - float(cdf[-1])) / p_tail).clamp(0, 1 - 1e-16)
    far = torch.floor((_ZIPF_TABLE + 0.5) * (1 - v).pow(-1 / (a - 1)) + 0.5)
    return torch.where(u < cdf[-1], head, far)


def papers_graph(scale, graph_seed, seed, device, homophily=0.7,
                 zipf_a=1.35, feat_dim=128, num_classes=172):
    """(src, dst) int64 without self-loops, x (N, F) float32, y (N,)
    int64, at ``scale`` of ogbn-papers100M's nodes and edges."""
    n = max(int(PAPERS_NODES * scale), 256)
    e = max(int(PAPERS_EDGES * scale), 4 * n)
    gen = torch.Generator(device=device).manual_seed(int(graph_seed))
    y = torch.randint(0, num_classes, (n,), generator=gen, device=device)
    dst = torch.randint(0, n, (e,), generator=gen, device=device)
    order = torch.argsort(y, stable=True)
    counts = torch.bincount(y, minlength=num_classes)
    starts = torch.cumsum(counts, 0) - counts
    yd = y[dst]
    pick = (torch.rand(e, generator=gen, device=device)
            * counts[yd]).long().clamp_max(counts[yd] - 1)
    same = order[starts[yd] + pick]
    anywhere = torch.remainder(zipf(gen, e, zipf_a, device) - 1, n).long()
    src = torch.where(torch.rand(e, generator=gen, device=device)
                      < homophily, same, anywhere)
    del same, anywhere, pick, yd
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn(n, feat_dim, generator=gen, device=device) * 0.5
    proto = torch.randn(num_classes, feat_dim, generator=gen, device=device)
    x += proto[y]
    return src, dst, x, y


def step_masks(n, count, share, seed, device):
    """``count`` disjoint row masks (float32, (N,)), each holding about
    ``share`` of the rows: the labelled rows of successive steps."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    u = torch.rand(n, generator=gen, device=device)
    return [((u >= i * share) & (u < (i + 1) * share)).float()
            for i in range(count)]
