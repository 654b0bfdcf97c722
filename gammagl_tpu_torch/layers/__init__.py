"""Layers."""

from gammagl_tpu_torch.layers.conv import (  # noqa: F401
    GATConv,
    GATV2Conv,
    GCNConv,
    HeteroConv,
    HGTConv,
    MessagePassing,
    SAGEConv,
)

__all__ = ["MessagePassing", "GCNConv", "GATConv", "GATV2Conv", "SAGEConv",
           "HeteroConv", "HGTConv"]
