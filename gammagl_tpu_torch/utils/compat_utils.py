"""Reference-name utility functions (counterpart of
`gammagl_tpu/utils/compat_utils.py`).

Semantics follow the reference (`gammagl/utils/`): `calc_A_norm_hat`
(spm_calc.py:4), `edge_index_to_adj_matrix` (convert.py:34),
`get_few_shot_split` (get_split.py:60), `node_subgraph` (subgraph.py:86),
`set_device` (device.py:10), `shortest_path_distance` /
`batched_shortest_path_distance` (shortest_path.py:66-80). Host numpy and
scipy, as in the JAX package, except `set_device`, which picks a torch
device.
"""

import numpy as np
import scipy.sparse as sp
import torch

__all__ = [
    "calc_A_norm_hat", "edge_index_to_adj_matrix", "get_few_shot_split",
    "node_subgraph", "set_device", "shortest_path_distance",
    "batched_shortest_path_distance",
]


def calc_A_norm_hat(edge_index, weights=None):
    """Symmetric-normalized adjacency with self-loops,
    D^-1/2 (A + I) D^-1/2, as a scipy sparse matrix (HiD-Net precompute)."""
    edge_index = np.asarray(edge_index)
    if weights is None:
        weights = np.ones(edge_index.shape[1])
    adj = sp.coo_matrix((weights, (edge_index[0], edge_index[1])))
    a = adj + sp.eye(adj.shape[0])
    d = np.asarray(a.sum(axis=1)).reshape(-1)
    d_invsqrt = sp.diags(1.0 / np.sqrt(np.maximum(d, 1e-12)))
    return d_invsqrt @ a @ d_invsqrt


def edge_index_to_adj_matrix(edge_index, num_src_nodes, num_dst_nodes):
    """COO edges -> scipy CSC adjacency (src x dst)."""
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    return sp.csc_matrix((np.ones(src.shape[0]), (src, dst)),
                         shape=(num_src_nodes, num_dst_nodes))


def get_few_shot_split(labels, num_shots, test_ratio=0.2, random_state=0):
    """Few-shot split: up to ``num_shots`` train nodes per class, test drawn
    from the remainder, by the JAX package's `np.random.RandomState` draws.
    Returns (train_idx, test_idx) int64 arrays."""
    if not (0 < test_ratio <= 1):
        raise ValueError("test_ratio must be in (0, 1].")
    labels = np.asarray(labels).reshape(-1)
    rng = np.random.RandomState(random_state)
    train = []
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        if idx.shape[0] <= num_shots:
            train.extend(idx.tolist())
        else:
            train.extend(rng.choice(idx, num_shots,
                                    replace=False).tolist())
    train = np.asarray(sorted(train), np.int64)
    pool = np.setdiff1d(np.arange(labels.shape[0]), train)
    n_test = max(1, int(round(test_ratio * pool.shape[0])))
    test = np.sort(rng.choice(pool, min(n_test, pool.shape[0]),
                              replace=False))
    return train, test.astype(np.int64)


def node_subgraph(graph, node_idx, num_hops=2):
    """Node-centered k-hop subgraph as a new `Graph`, with ``target_node``
    marking the seed's position after relabeling and ``subset`` the
    original ids."""
    from gammagl_tpu_torch.data import Graph
    from gammagl_tpu_torch.utils.subgraph import k_hop_subgraph

    subset, edge_index, mapping, _ = k_hop_subgraph(
        node_idx, num_hops, graph.edge_index, relabel_nodes=True,
        num_nodes=graph.num_nodes)
    subset = np.asarray(subset)
    x = None if graph.x is None else np.asarray(graph.x)[subset]
    g = Graph(x=x, edge_index=np.asarray(edge_index),
              num_nodes=int(subset.shape[0]))
    g.target_node = int(np.asarray(mapping).reshape(-1)[0])
    g.subset = subset
    return g


def set_device(id=0, platform=None):
    """Make CUDA device ``id`` the current one and return it (reference
    device.py pins a GPU; the JAX package picks its default device).

    An ``id`` outside the visible cards picks card 0, as the JAX package
    does. ``platform="cpu"`` is the only way to the host: it returns the
    CPU device and pins nothing. Without a card, and without
    ``platform="cpu"``, it raises: it never hands back the CPU in place
    of a card.
    """
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "cuda", "gpu"):
        raise ValueError(f"set_device: unknown platform {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("set_device: torch sees no CUDA device (pass "
                           "platform='cpu' for the host)")
    n = torch.cuda.device_count()
    dev = torch.device("cuda", id if 0 <= id < n else 0)
    torch.cuda.set_device(dev)
    return dev


def _paths_from_graph(edge_index, num_nodes, shift=0):
    """All-pairs BFS node paths + edge paths (Graphormer precompute).

    Returns ({src: {dst: [nodes]}}, {src: {dst: [edge ids]}}) with node
    ids offset by ``shift`` (used for batched graphs).
    """
    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    nbrs = [[] for _ in range(num_nodes)]
    for e in range(src.shape[0]):
        nbrs[int(src[e])].append((int(dst[e]), e))
    node_paths, edge_paths = {}, {}
    for s in range(num_nodes):
        prev = {s: (None, None)}
        frontier = [s]
        while frontier:
            nxt = []
            for u in frontier:
                for v, e in nbrs[u]:
                    if v not in prev:
                        prev[v] = (u, e)
                        nxt.append(v)
            frontier = nxt
        np_s, ep_s = {}, {}
        for t in prev:
            nodes, edges = [t], []
            u = t
            while prev[u][0] is not None:
                p, e = prev[u]
                nodes.append(p)
                edges.append(e)
                u = p
            np_s[t + shift] = [n + shift for n in reversed(nodes)]
            ep_s[t + shift] = list(reversed(edges))
        node_paths[s + shift] = np_s
        edge_paths[s + shift] = ep_s
    return node_paths, edge_paths


def shortest_path_distance(data):
    """(node_paths, edge_paths) dicts for one graph (reference
    shortest_path.py:66 via networkx; here a direct BFS, as in the JAX
    package; `utils.shortest_path` gives the distance matrix)."""
    return _paths_from_graph(np.asarray(data.edge_index), data.num_nodes)


def batched_shortest_path_distance(data):
    """Same over a `BatchGraph`: per-subgraph BFS with node ids shifted to
    batch-global numbering, merged into one dict pair."""
    node_paths, edge_paths = {}, {}
    shift = 0
    for g in data.to_data_list():
        n_p, e_p = _paths_from_graph(np.asarray(g.edge_index),
                                     g.num_nodes, shift=shift)
        node_paths.update(n_p)
        edge_paths.update(e_p)
        shift += g.num_nodes
    return node_paths, edge_paths
