"""Graph data containers."""

from gammagl_tpu_torch.data.graph import Graph  # noqa: F401
from gammagl_tpu_torch.data.heterograph import HeteroGraph  # noqa: F401

__all__ = ["Graph", "HeteroGraph"]
