"""Layers."""

from gammagl_tpu_torch.layers import pool  # noqa: F401
from gammagl_tpu_torch.layers import attention  # noqa: F401

from gammagl_tpu_torch.layers.conv import (  # noqa: F401
    GATConv,
    GATV2Conv,
    GCNConv,
    HANConv,
    HeteroConv,
    HGTConv,
    MessagePassing,
    RGCNConv,
    SAGEConv,
    SimpleHGNConv,
)

__all__ = ["MessagePassing", "GCNConv", "GATConv", "GATV2Conv", "SAGEConv",
           "RGCNConv", "HeteroConv", "HANConv", "HGTConv", "SimpleHGNConv"]
