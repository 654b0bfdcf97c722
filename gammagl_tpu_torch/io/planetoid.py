"""Planetoid file-format reader (counterpart of `gammagl_tpu/io/planetoid.py`;
reference: gammagl/io/planetiod.py:17): ``ind.<name>.{x, tx, allx, y, ty,
ally, graph, test.index}``, pickled scipy matrices and an adjacency dict.
Citeseer's test indices leave gaps (isolated nodes): its test block is
re-densified, as in the reference."""

import os.path as osp
import pickle
from itertools import repeat

import numpy as np

from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.io.txt_array import read_txt_array
from gammagl_tpu_torch.utils.coalesce import coalesce
from gammagl_tpu_torch.utils.loop import remove_self_loops
from gammagl_tpu_torch.utils.mask import index_to_mask

__all__ = ["read_planetoid_data"]


def _read_file(folder, prefix, name):
    path = osp.join(folder, f"ind.{prefix.lower()}.{name}")
    if name == "test.index":
        return read_txt_array(path)
    with open(path, "rb") as f:
        out = pickle.load(f, encoding="latin1")
    if name == "graph":
        return out
    out = out.todense() if hasattr(out, "todense") else out
    return np.array(out)


def _edge_index_from_dict(graph_dict, num_nodes=None):
    row, col = [], []
    for key, value in graph_dict.items():
        row += list(repeat(key, len(value)))
        col += list(value)
    edge_index = np.stack([np.array(row), np.array(col)])
    edge_index, _ = remove_self_loops(edge_index)
    return coalesce(edge_index, num_nodes=num_nodes)


def read_planetoid_data(folder, prefix):
    """The `Graph` of the eight files of ``prefix`` in ``folder``: float32
    ``x``, int64 ``y``, coalesced ``edge_index`` without self-loops, and
    the public split's masks (the labeled rows, the next 500, the test
    indices)."""
    names = ["x", "tx", "allx", "y", "ty", "ally", "graph", "test.index"]
    x, tx, allx, y, ty, ally, graph, test_index = [
        _read_file(folder, prefix, n) for n in names]
    train_index = np.arange(y.shape[0])
    val_index = np.arange(y.shape[0], y.shape[0] + 500)
    sorted_test_index = np.sort(test_index)

    if prefix.lower() == "citeseer":
        len_test = int(test_index.max() - test_index.min()) + 1
        tx_ext = np.zeros((len_test, tx.shape[1]))
        tx_ext[sorted_test_index - test_index.min()] = tx
        ty_ext = np.zeros((len_test, ty.shape[1]))
        ty_ext[sorted_test_index - test_index.min()] = ty
        tx, ty = tx_ext, ty_ext

    x = np.concatenate([allx, tx]).astype(np.float32)
    x[test_index] = x[sorted_test_index]
    y = np.concatenate([ally, ty]).argmax(1).astype(np.int64)
    y[test_index] = y[sorted_test_index]

    data = Graph(x=x, edge_index=_edge_index_from_dict(
        graph, num_nodes=y.shape[0]), y=y)
    data.train_mask = index_to_mask(train_index, y.shape[0])
    data.val_mask = index_to_mask(val_index, y.shape[0])
    data.test_mask = index_to_mask(test_index, y.shape[0])
    return data
