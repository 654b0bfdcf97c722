"""Layers."""

from gammagl_tpu_torch.layers.conv import (  # noqa: F401
    GATConv,
    GCNConv,
    MessagePassing,
)

__all__ = ["MessagePassing", "GCNConv", "GATConv"]
