"""All-pairs shortest paths and the padded spatial encodings of
Graphormer (counterpart of `gammagl_tpu/utils/shortest_path.py`;
reference: gammagl/utils/shortest_path.py).

Host numpy: scipy's BFS over a CSR adjacency (a list BFS where scipy is
missing), and `bucketed_spatial_encoding`, which pads each graph's
distance matrix into a bucket of fixed size so one batch shape serves
every graph of the bucket.
"""

import numpy as np

__all__ = ["shortest_path", "bucketed_spatial_encoding"]


def shortest_path(edge_index, num_nodes, max_dist=None, clip_far=True):
    """Dense (N, N) int64 hop-distance matrix; unreachable pairs get -1.

    With ``max_dist``: under ``clip_far=True`` (the default) reachable
    pairs farther than ``max_dist`` clamp to ``max_dist`` (Graphormer's
    shortest-path clip) while unreachable pairs stay -1; under
    ``clip_far=False`` the far pairs are -1 too.
    """
    ei = np.asarray(edge_index)
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import shortest_path as _sp
        adj = sp.csr_matrix(
            (np.ones(ei.shape[1], np.int8), (ei[0], ei[1])),
            shape=(num_nodes, num_nodes))
        dist = _sp(adj, method="D", unweighted=True, directed=True)
        out = np.where(np.isinf(dist), -1, dist).astype(np.int64)
    except ImportError:  # pragma: no cover - scipy is a dependency
        out = _bfs_python(ei, num_nodes)
    if max_dist is not None:
        out = np.where(out > max_dist, max_dist if clip_far else -1, out)
    return out


def _bfs_python(ei, num_nodes):
    """The same matrix by a BFS from every node over adjacency lists."""
    adj = [[] for _ in range(num_nodes)]
    for s, d in ei.T:
        adj[s].append(int(d))
    dist = np.full((num_nodes, num_nodes), -1, dtype=np.int64)
    for start in range(num_nodes):
        dist[start, start] = 0
        frontier = [start]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[start, v] < 0:
                        dist[start, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def bucketed_spatial_encoding(graphs, buckets=(16, 32, 64, 128),
                              max_dist=8):
    """Pad per-graph distance matrices into buckets of fixed size.

    ``graphs``: objects with ``edge_index`` and ``num_nodes``. Each lands
    in the smallest bucket that fits; a larger graph gets a bucket of its
    own size rounded up to a multiple of 8. Returns {bucket size:
    {"dist": (B, S, S) int32 with -1 on padded rows and columns, "mask":
    (B, S) bool of the real nodes, "index": the graphs' positions in
    ``graphs``}}. Unreachable and padded pairs share the id -1, Graphormer's
    "no spatial relation" row.
    """
    out = {}
    for pos, g in enumerate(graphs):
        n = int(g.num_nodes)
        size = next((b for b in buckets if n <= b), -(-n // 8) * 8)
        d = shortest_path(np.asarray(g.edge_index), n, max_dist=max_dist)
        pad = np.full((size, size), -1, np.int32)
        pad[:n, :n] = d
        mask = np.zeros(size, bool)
        mask[:n] = True
        slot = out.setdefault(size, {"dist": [], "mask": [], "index": []})
        slot["dist"].append(pad)
        slot["mask"].append(mask)
        slot["index"].append(pos)
    return {size: {"dist": np.stack(v["dist"]), "mask": np.stack(v["mask"]),
                   "index": v["index"]}
            for size, v in out.items()}
