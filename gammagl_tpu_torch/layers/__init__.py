"""Layers."""

from gammagl_tpu_torch.layers.conv import GCNConv, MessagePassing  # noqa: F401

__all__ = ["MessagePassing", "GCNConv"]
