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
from gammagl_tpu_torch.models.ssl import (  # noqa: F401
    DGIModel,
    GGDModel,
    GraceModel,
    InfoGraph,
    MVGRLModel,
    corrupt_features,
    drop_edge_and_feature,
    grace_loss,
)
from gammagl_tpu_torch.models.autoencoder import (  # noqa: F401
    GAEModel,
    VGAEModel,
    inner_product_decoder,
    recon_loss,
)
from gammagl_tpu_torch.models.spectral import (  # noqa: F401
    MGNNIModel,
    SpecformerModel,
    laplacian_eigh,
)

# the reference's spellings (gammagl/models/__init__.py)
HPN = HPNModel
HeCo = HeCoModel
Hid_net = HiDNetModel
RoheHAN = RoheHANModel
Specformer = SpecformerModel
MGNNI_m_MLP = MGNNIModel  # the MLP-injection multiscale variant

__all__ = ["GCNModel", "GATModel", "GATV2Model", "GraphSAGEModel",
           "GraphSAGESampleModel", "RGCNModel", "HANModel", "HGTModel",
           "SimpleHGNModel", "SGCModel", "GINModel", "APPNPModel",
           "GCNIIModel", "JKNet", "MLP", "ChebNetModel", "MixHopModel",
           "GPRGNNModel", "FAGCNModel", "HiDNetModel", "HPNModel",
           "ieHGCNModel", "RoheHANModel", "HeCoModel", "heco_contrast_loss",
           "HPN", "HeCo", "Hid_net", "RoheHAN", "PNAModel", "CompGCNModel",
           "DGCNNModel", "GaANModel", "DGIModel", "GraceModel",
           "MVGRLModel", "InfoGraph", "GGDModel", "grace_loss",
           "corrupt_features", "drop_edge_and_feature", "GAEModel",
           "VGAEModel", "inner_product_decoder", "recon_loss",
           "SpecformerModel", "laplacian_eigh", "MGNNIModel", "Specformer",
           "MGNNI_m_MLP"]
