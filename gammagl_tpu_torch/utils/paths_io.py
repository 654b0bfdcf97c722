"""Simple-path enumeration, embedding file IO and the Inspector shim
(counterpart of `gammagl_tpu/utils/paths_io.py`; host Python and numpy).

Reference: gammagl/utils/{simple_path.py find_all_simple_paths,
read_embeddings.py, inspector.py}. The embedding files are word2vec's
text layout, written and read as the JAX package does, so a file written
by either package reads back bitwise in the other.
"""

import inspect as _inspect

import numpy as np

__all__ = ["find_all_simple_paths", "read_embeddings", "save_embeddings",
           "Inspector"]


def find_all_simple_paths(edge_index, src, dest, max_length):
    """All simple paths src -> dest up to max_length nodes (host DFS)."""
    ei = np.asarray(edge_index)
    n = int(ei.max()) + 1 if ei.size else 0
    adj = [[] for _ in range(n)]
    for s, d in ei.T:
        adj[int(s)].append(int(d))
    paths, stack = [], [(int(src), [int(src)])]
    while stack:
        node, path = stack.pop()
        if node == dest and len(path) > 1 or (
                node == dest and src == dest and len(path) == 1):
            paths.append(path)
            continue
        if len(path) >= max_length:
            continue
        for nxt in adj[node]:
            if nxt not in path or nxt == dest:
                if nxt == dest:
                    paths.append(path + [nxt])
                else:
                    stack.append((nxt, path + [nxt]))
    return paths


def read_embeddings(path, num_nodes=None, dim=None):
    """word2vec-format embedding file -> (N, D) array
    (reference read_embeddings.py)."""
    with open(path) as f:
        header = f.readline().split()
        n, d = int(header[0]), int(header[1])
        if num_nodes is not None:
            n = max(n, num_nodes)
        out = np.zeros((n, d), np.float32)
        for line in f:
            parts = line.rstrip().split()
            if len(parts) != d + 1:
                continue
            out[int(parts[0])] = [float(v) for v in parts[1:]]
    return out


def save_embeddings(path, emb):
    """(N, D) array or tensor -> word2vec-format text file, six decimals
    a value."""
    if hasattr(emb, "detach"):
        emb = emb.detach().cpu().numpy()
    emb = np.asarray(emb)
    with open(path, "w") as f:
        f.write(f"{emb.shape[0]} {emb.shape[1]}\n")
        for i, row in enumerate(emb):
            f.write(f"{i} " + " ".join(f"{v:.6f}" for v in row) + "\n")


class Inspector:
    """Signature-reflection helper kept for API parity (reference
    gammagl/utils/inspector.py:25,90). The port's MessagePassing takes
    explicit arguments instead, but downstream code porting from the
    reference can still use this to route kwargs."""

    def __init__(self, base_class):
        self.base_class = base_class
        self.params = {}

    def inspect(self, func, pop_first=False):
        params = dict(_inspect.signature(func).parameters)
        if pop_first and params:
            params.pop(next(iter(params)))
        params.pop("self", None)
        self.params[getattr(func, "__name__", str(func))] = params
        return self

    def keys(self, func_names=None):
        keys = set()
        for name in (func_names or self.params):
            keys |= set(self.params.get(name, {}))
        return keys

    def distribute(self, func_name, kwargs):
        out = {}
        for key, param in self.params.get(func_name, {}).items():
            if key in kwargs:
                out[key] = kwargs[key]
            elif param.default is not _inspect.Parameter.empty:
                out[key] = param.default
        return out
