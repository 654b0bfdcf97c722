"""Padding and bucketing to fixed sizes (counterpart of
`gammagl_tpu/data/padding.py`).

The JAX package pads so XLA compiles once per bucket. The port keeps the
same pads, so a padded graph means the same thing in both packages:
padded edges point src -> num_nodes and dst -> num_nodes (the padded
count, outside every node range), which the port's COO ops treat as the
JAX ones do (gathers clamp, reductions drop them), and ``node_mask`` /
``edge_mask`` mark the real entries. A plan of a padded graph raises:
`build_csr_plan` refuses edges out of range, as the JAX one does.
Host numpy.
"""

import math

import numpy as np

from gammagl_tpu_torch.data.graph import Graph, _host

__all__ = ["pad_graph", "size_bucket", "pad_to"]


def size_bucket(n, base=64, factor=1.25):
    """Smallest bucket >= n on a geometric grid of `base * factor**k`."""
    if n <= base:
        return base
    k = math.ceil(math.log(n / base) / math.log(factor))
    return int(math.ceil(base * factor ** k / base) * base)


def pad_to(arr, size, axis=0, fill=0):
    """``arr`` padded with ``fill`` to ``size`` along ``axis``."""
    arr = np.asarray(_host(arr))
    pad = size - arr.shape[axis]
    if pad < 0:
        raise ValueError(
            f"array dim {arr.shape[axis]} exceeds pad size {size}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def pad_graph(graph: Graph, num_nodes=None, num_edges=None, bucket=False):
    """``graph`` padded to (num_nodes, num_edges), by default its own
    sizes, or with ``bucket=True`` the `size_bucket` of each. Per-node
    and per-edge arrays are padded with zeros, ``edge_index`` with the
    padded node count; ``node_mask`` / ``edge_mask`` mark the real rows."""
    n, e = graph.num_nodes, graph.num_edges
    if num_nodes is None:
        num_nodes = size_bucket(n) if bucket else n
    if num_edges is None:
        num_edges = size_bucket(e) if bucket else e
    g = Graph(num_nodes=num_nodes)
    for k, v in graph.items():
        v = np.asarray(_host(v))
        if k == "edge_index":
            g[k] = pad_to(v, num_edges, axis=1, fill=num_nodes)
        elif v.ndim > 0 and v.shape[0] == n:
            g[k] = pad_to(v, num_nodes, axis=0)
        elif v.ndim > 0 and v.shape[0] == e:
            g[k] = pad_to(v, num_edges, axis=0)
        else:
            g[k] = v
    g["node_mask"] = np.arange(num_nodes) < n
    g["edge_mask"] = np.arange(num_edges) < e
    return g
