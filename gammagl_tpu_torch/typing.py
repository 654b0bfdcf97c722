"""Common type aliases (counterpart of `gammagl_tpu/typing.py`): the same
names over `torch.Tensor` in place of ``jax.Array``.

Reference: gammagl/data/graph_store.py:47-59 (edge layouts) and
gammagl/data/heterograph.py:20 (typed graphs).
"""

from typing import Any, Dict, Optional, Tuple

import torch

Array = torch.Tensor
ArrayLike = Any  # tensors, numpy arrays, python scalars

# Heterogeneous graph typing (reference: gammagl/data/heterograph.py:20).
NodeType = str
EdgeType = Tuple[str, str, str]  # (src_type, relation, dst_type)
Metadata = Tuple[list, list]

OptArray = Optional[Array]
AdjDict = Dict[EdgeType, Array]
FeatDict = Dict[NodeType, Array]

__all__ = [
    "Array",
    "ArrayLike",
    "NodeType",
    "EdgeType",
    "Metadata",
    "OptArray",
    "AdjDict",
    "FeatDict",
]
