"""Assembled GNN models."""

from gammagl_tpu_torch.models.gcn import GCNModel  # noqa: F401
from gammagl_tpu_torch.models.gat import GATModel, GATV2Model  # noqa: F401
from gammagl_tpu_torch.models.graphsage import (  # noqa: F401
    GraphSAGEModel,
    GraphSAGESampleModel,
)
from gammagl_tpu_torch.models.hetero import (  # noqa: F401
    HANModel,
    HGTModel,
    RGCNModel,
    SimpleHGNModel,
)

__all__ = ["GCNModel", "GATModel", "GATV2Model", "GraphSAGEModel",
           "GraphSAGESampleModel", "RGCNModel", "HANModel", "HGTModel",
           "SimpleHGNModel"]
