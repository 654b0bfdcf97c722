"""RGT's structure-extraction loaders (counterpart of
`gammagl_tpu/loader/rgt_loader.py`; reference:
gammagl/loader/rgt_loader.py).

For every seed m of a sampled batch: a BFS tree, a short cycle (or a BFS
sequence where none closes) and a truncated BFS sequence over the sampled
subgraph, in the node-id block [m * N, (m + 1) * N) of the tiled space.
Host numpy, as in JAX: BFS over a CSR adjacency of the subgraph, and one
padded edge buffer of fixed shape (2, batch_size * cap) per structure,
padded with the id num_seeds * N, which the segment ops drop. An LRU
cache keeps whole batches when the loader does not shuffle.
"""

from collections import OrderedDict, deque

import numpy as np

from gammagl_tpu_torch.loader.link_loader import LinkLoader
from gammagl_tpu_torch.loader.node_loader import NodeLoader
from gammagl_tpu_torch.sampler.neighbor_sampler import NeighborSampler

__all__ = ["ExtractNodeLoader", "ExtractLinkLoader", "LRUCache",
           "build_structure_batch"]

_STRUCTURES = ("edge_index", "tree_edge_index", "cycle_edge_index",
               "seq_edge_index")


class LRUCache:
    """A batch cache of at most ``capacity`` entries, least recently used
    out first."""

    def __init__(self, capacity=1000):
        self.capacity = capacity
        self._d = OrderedDict()

    def get(self, key):
        if key not in self._d:
            return None
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __contains__(self, key):
        return key in self._d

    def clear(self):
        self._d.clear()


def _csr_from_edges(edge_index, num_nodes):
    """Undirected CSR adjacency without self-loops (the reference's
    ``nx.Graph``)."""
    src = np.concatenate([edge_index[0], edge_index[1]])
    dst = np.concatenate([edge_index[1], edge_index[0]])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    ptr = np.zeros(num_nodes + 1, np.int64)
    np.add.at(ptr, src + 1, 1)
    return np.cumsum(ptr), dst


def _bfs_edges(ptr, col, start, max_edges):
    """The first ``max_edges`` BFS tree edges from ``start``, neighbours
    in sorted order."""
    n = len(ptr) - 1
    if start >= n:
        return []
    seen = np.zeros(n, bool)
    seen[start] = True
    q = deque([start])
    edges = []
    while q and len(edges) < max_edges:
        u = q.popleft()
        for v in np.sort(col[ptr[u]:ptr[u + 1]]):
            if not seen[v]:
                seen[v] = True
                edges.append((u, int(v)))
                q.append(int(v))
                if len(edges) >= max_edges:
                    break
    return edges


def _bfs_sequence(ptr, col, start, length):
    """The BFS node sequence from ``start``, at most ``length`` long."""
    n = len(ptr) - 1
    if start >= n:
        return [start]
    seq = [start]
    seen = {start}
    q = deque([start])
    while len(seq) < length and q:
        u = q.popleft()
        for v in np.sort(col[ptr[u]:ptr[u + 1]]):
            v = int(v)
            if v not in seen:
                seen.add(v)
                seq.append(v)
                q.append(v)
                if len(seq) >= length:
                    break
    return seq


def _undirect(edges):
    """An edge list and its reverse, (2, 2 len) int64."""
    if not edges:
        return np.zeros((2, 0), np.int64)
    e = np.asarray(edges, np.int64).T
    return np.concatenate([e, e[::-1]], axis=1)


def build_structure_batch(edge_index, num_nodes, batch_size,
                          max_tree_edges=32, max_cycle_edges=3,
                          max_seq_edges=4):
    """The tree, cycle and sequence edge buffers of one sampled subgraph
    whose seeds are its first ``batch_size`` nodes: seed m owns the ids
    [m * num_nodes, (m + 1) * num_nodes). Returns three int64 arrays of
    shapes (2, batch_size * 2 * cap) for the caps ``max_tree_edges``,
    ``max_cycle_edges`` and ``max_seq_edges``, padded with
    ``batch_size * num_nodes``."""
    ptr, col = _csr_from_edges(np.asarray(edge_index), num_nodes)
    pad_id = batch_size * num_nodes

    def _padded(per_seed_edges, cap):
        buf = np.full((2, batch_size * cap), pad_id, np.int64)
        for m, e in enumerate(per_seed_edges):
            e = e[:, :cap] + m * num_nodes
            buf[:, m * cap:m * cap + e.shape[1]] = e
        return buf

    trees, cycles, seqs = [], [], []
    for m in range(batch_size):
        tree = _bfs_edges(ptr, col, m, max_tree_edges)
        trees.append(_undirect(tree))
        cyc_edges = tree[:max_cycle_edges - 1]
        nodes = {u for e in cyc_edges for u in e}
        if (len(nodes) == max_cycle_edges and cyc_edges
                and cyc_edges[0][0] == cyc_edges[-1][1]):
            cycles.append(_undirect(cyc_edges))
        else:
            seq = _bfs_sequence(ptr, col, m, max_cycle_edges)
            cycles.append(_undirect(list(zip(seq[:-1], seq[1:]))))
        seqs.append(_undirect(tree[:max_seq_edges - 1]))
    return (_padded(trees, 2 * max_tree_edges),
            _padded(cycles, 2 * max_cycle_edges),
            _padded(seqs, 2 * max_seq_edges))


def _attach(sub, n, seeds, loader):
    """The three structure buffers of ``sub`` (``n`` nodes, ``seeds``
    seeds) and ``num_seeds``, set on ``sub``."""
    sub.tree_edge_index, sub.cycle_edge_index, sub.seq_edge_index = \
        build_structure_batch(sub.edge_index, n, seeds,
                              max_tree_edges=loader.max_tree_edges,
                              max_cycle_edges=loader.max_depth_cycle,
                              max_seq_edges=loader.sequence_length)
    sub.num_seeds = seeds


class _Cached:
    """Batch iteration through the LRU cache: without shuffling, batch i
    of a later epoch is batch i of the first."""

    def __iter__(self):
        for key, sub in enumerate(super().__iter__()):
            cached = self.cache.get(key) if not self.shuffle else None
            if cached is not None:
                yield cached
                continue
            sub = self._augment(sub)
            if not self.shuffle:
                self.cache.put(key, sub)
            yield sub

    def clear_cache(self):
        self.cache.clear()


class ExtractNodeLoader(_Cached, NodeLoader):
    """Neighbour-sampled node batches (the port's C++ `NeighborSampler`,
    ``drop_last``) with the tree, cycle and sequence buffers. Every batch
    is padded to ``pad_num_nodes`` nodes (default batch_size *
    prod(fanout + 1)), so its shapes are fixed: per-node arrays get zero
    rows, the structures address the padded id space."""

    def __init__(self, graph, num_neighbors, input_nodes=None, batch_size=32,
                 shuffle=True, capacity=1000, max_depth_cycle=3,
                 sequence_length=4, max_tree_edges=32, pad_num_nodes=None,
                 replace=False, seed=None):
        sampler = NeighborSampler(np.asarray(graph.edge_index),
                                  graph.num_nodes, num_neighbors,
                                  replace=replace, seed=seed)
        super().__init__(graph, sampler, input_nodes=input_nodes,
                         batch_size=batch_size, shuffle=shuffle,
                         drop_last=True, seed=seed)
        self.cache = LRUCache(capacity)
        self.max_depth_cycle = max_depth_cycle
        self.sequence_length = sequence_length
        self.max_tree_edges = max_tree_edges
        if pad_num_nodes is None:
            fan = 1
            for f in num_neighbors:
                fan *= (f + 1)
            pad_num_nodes = batch_size * fan
        self.pad_num_nodes = pad_num_nodes

    def _augment(self, sub):
        n = int(sub.num_nodes)
        n_pad = max(self.pad_num_nodes, n)
        _attach(sub, n_pad, int(sub.batch_size), self)
        if n_pad > n:
            for k, v in list(sub.items()):
                v = np.asarray(v)
                if v.ndim > 0 and k not in _STRUCTURES and v.shape[0] == n:
                    pad = np.zeros((n_pad - n,) + v.shape[1:], v.dtype)
                    sub[k] = np.concatenate([v, pad], axis=0)
            sub.num_nodes = n_pad
        return sub


class ExtractLinkLoader(_Cached, LinkLoader):
    """The edge-seeded form: link batches sampled around both endpoints,
    with the same structure buffers (no node padding)."""

    def __init__(self, graph, num_neighbors, edge_label_index=None,
                 batch_size=32, shuffle=True, capacity=1000,
                 max_depth_cycle=3, sequence_length=4, max_tree_edges=32,
                 replace=False, seed=None, **kw):
        sampler = NeighborSampler(np.asarray(graph.edge_index),
                                  graph.num_nodes, num_neighbors,
                                  replace=replace, seed=seed)
        super().__init__(graph, sampler, edge_label_index=edge_label_index,
                         batch_size=batch_size, shuffle=shuffle, **kw)
        self.cache = LRUCache(capacity)
        self.max_depth_cycle = max_depth_cycle
        self.sequence_length = sequence_length
        self.max_tree_edges = max_tree_edges

    def _augment(self, sub):
        n = int(sub.num_nodes)
        seeds = int(getattr(sub, "batch_size", self.batch_size)
                    or self.batch_size)
        _attach(sub, n, min(seeds, n), self)
        return sub
