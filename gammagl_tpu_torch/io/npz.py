"""Sparse .npz graph reader, the Amazon / Coauthor format (counterpart of
`gammagl_tpu/io/npz.py`; reference: gammagl/io/npz.py): CSR attributes
and adjacency, features binarized, self-loops removed, edges made
undirected."""

import numpy as np

from gammagl_tpu_torch.data.graph import Graph
from gammagl_tpu_torch.utils.loop import remove_self_loops
from gammagl_tpu_torch.utils.undirected import to_undirected

__all__ = ["read_npz", "parse_npz"]


def read_npz(path):
    with np.load(path, allow_pickle=True) as f:
        return parse_npz(f)


def parse_npz(data):
    import scipy.sparse as sp

    x = np.asarray(sp.csr_matrix(
        (data["attr_data"], data["attr_indices"], data["attr_indptr"]),
        data["attr_shape"]).todense())
    x[x > 0] = 1
    adj = sp.csr_matrix(
        (data["adj_data"], data["adj_indices"], data["adj_indptr"]),
        data["adj_shape"]).tocoo()
    edge_index = np.stack([adj.row, adj.col]).astype(np.int64)
    edge_index, _ = remove_self_loops(edge_index)
    edge_index = to_undirected(edge_index, num_nodes=x.shape[0])
    return Graph(x=x.astype(np.float32), edge_index=edge_index,
                 y=np.asarray(data["labels"]).astype(np.int64))
