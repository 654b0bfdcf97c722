"""TU-dataset reader, the graph-classification collections (counterpart
of `gammagl_tpu/io/tu.py`; reference: gammagl/io/tu.py:17):
``DS_A.txt`` edges, ``DS_graph_indicator.txt`` the graph of each node,
optional node and edge labels and attributes, ``DS_graph_labels.txt``."""

import glob
import os.path as osp

import numpy as np

from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.io.txt_array import read_txt_array

__all__ = ["read_tu_data"]


def _cat(seq):
    seq = [s.reshape(s.shape[0], -1) for s in seq if s is not None]
    return np.concatenate(seq, axis=-1) if seq else None


def _one_hot(labels):
    labels = labels - labels.min()
    out = np.zeros((labels.shape[0], int(labels.max()) + 1), np.float32)
    out[np.arange(labels.shape[0]), labels] = 1
    return out


def read_tu_data(folder, prefix):
    """One `Graph` a graph of the collection: ``x`` (attributes, then
    one-hot labels), ``edge_attr`` likewise, ``edge_index`` in the
    graph's own ids, ``y`` (1,) its class (``graph_labels`` renumbered
    from 0) or its attributes."""
    files = glob.glob(osp.join(folder, f"{prefix}_*.txt"))
    names = [osp.basename(f)[len(prefix) + 1:-4] for f in files]

    def path(name):
        return osp.join(folder, f"{prefix}_{name}.txt")

    edge_index = read_txt_array(path("A"), sep=",").T - 1
    batch = read_txt_array(path("graph_indicator")) - 1

    node_attrs = node_labels = None
    if "node_attributes" in names:
        node_attrs = read_txt_array(path("node_attributes"), sep=",",
                                    dtype=np.float32)
    if "node_labels" in names:
        node_labels = _one_hot(read_txt_array(path("node_labels")))
    x = _cat([node_attrs, node_labels])

    edge_attrs = edge_labels = None
    if "edge_attributes" in names:
        edge_attrs = read_txt_array(path("edge_attributes"), sep=",",
                                    dtype=np.float32)
    if "edge_labels" in names:
        edge_labels = _one_hot(read_txt_array(path("edge_labels")))
    edge_attr = _cat([edge_attrs, edge_labels])

    y = None
    if "graph_labels" in names:
        _, y = np.unique(read_txt_array(path("graph_labels")),
                         return_inverse=True)
    elif "graph_attributes" in names:
        y = read_txt_array(path("graph_attributes"), dtype=np.float32)

    num_graphs = int(batch.max()) + 1
    node_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        batch.astype(np.int64), minlength=num_graphs))])
    edge_batch = batch[edge_index[0]]
    graphs = []
    for g in range(num_graphs):
        lo, hi = node_ptr[g], node_ptr[g + 1]
        emask = edge_batch == g
        graph = Graph(edge_index=edge_index[:, emask] - lo,
                      num_nodes=int(hi - lo))
        if x is not None:
            graph.x = x[lo:hi]
        if edge_attr is not None:
            graph.edge_attr = edge_attr[emask]
        if y is not None:
            graph.y = np.asarray([y[g]])
        graphs.append(graph)
    return graphs
