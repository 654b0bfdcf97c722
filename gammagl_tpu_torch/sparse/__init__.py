"""Sparse adjacency containers on the host (counterpart of
`gammagl_tpu/sparse/`): `SparseGraph`, a COO adjacency with cached CSR and
CSC forms and layered neighbour sampling, and `CSRAdj`."""

from gammagl_tpu_torch.sparse.sparse_graph import (  # noqa: F401
    CSRAdj,
    SparseGraph,
)

__all__ = ["SparseGraph", "CSRAdj"]
