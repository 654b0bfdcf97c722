"""Attention layers: Graphormer's and RGT's (counterpart of
`gammagl_tpu/layers/attention/`)."""

from gammagl_tpu_torch.layers.attention.graphormer import (  # noqa: F401
    CentralityEncoder,
    EdgeEncoder,
    GraphormerLayer,
    SpatialEncoder,
)
from gammagl_tpu_torch.layers.attention.rgt import (  # noqa: F401
    CrossManifoldAttention,
    EuclideanAttention,
    EuclideanStructureLearner,
    HyperbolicStructureLearner,
    SphericalStructureLearner,
)

__all__ = ["CentralityEncoder", "SpatialEncoder", "EdgeEncoder",
           "GraphormerLayer", "CrossManifoldAttention", "EuclideanAttention",
           "HyperbolicStructureLearner", "SphericalStructureLearner",
           "EuclideanStructureLearner"]
