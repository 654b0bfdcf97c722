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

from gammagl_tpu_torch.models.simple_models import (  # noqa: F401
    MLP,
    APPNPModel,
    ChebNetModel,
    FAGCNModel,
    GCNIIModel,
    GINModel,
    GPRGNNModel,
    JKNet,
    MixHopModel,
    SGCModel,
)
from gammagl_tpu_torch.models.wave3_models import (  # noqa: F401
    HiDNetModel,
    HPNModel,
    RoheHANModel,
    ieHGCNModel,
)
from gammagl_tpu_torch.models.heco import (  # noqa: F401
    HeCoModel,
    heco_contrast_loss,
)
from gammagl_tpu_torch.models.wave2_models import (  # noqa: F401
    CompGCNModel,
    DGCNNModel,
    GaANModel,
    PNAModel,
)

# the reference's spellings (gammagl/models/__init__.py)
HPN = HPNModel
HeCo = HeCoModel
Hid_net = HiDNetModel
RoheHAN = RoheHANModel

__all__ = ["GCNModel", "GATModel", "GATV2Model", "GraphSAGEModel",
           "GraphSAGESampleModel", "RGCNModel", "HANModel", "HGTModel",
           "SimpleHGNModel", "SGCModel", "GINModel", "APPNPModel",
           "GCNIIModel", "JKNet", "MLP", "ChebNetModel", "MixHopModel",
           "GPRGNNModel", "FAGCNModel", "HiDNetModel", "HPNModel",
           "ieHGCNModel", "RoheHANModel", "HeCoModel", "heco_contrast_loss",
           "HPN", "HeCo", "Hid_net", "RoheHAN", "PNAModel", "CompGCNModel",
           "DGCNNModel", "GaANModel"]
