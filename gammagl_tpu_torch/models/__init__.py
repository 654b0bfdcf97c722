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

from gammagl_tpu_torch.models.wave5_models import (  # noqa: F401
    AdaGADModel,
    GCNUniFews,
    HardGATConv,
    HardGATModel,
    SIGNModel,
    Sp2GCLModel,
)
from gammagl_tpu_torch.models.wave6_models import (  # noqa: F401
    AMPModel,
    EdgePromptModel,
    GCILModel,
    MAGCLModel,
    SFGCNModel,
    dfad_generator_loss,
    dfad_student_loss,
)
from gammagl_tpu_torch.models.wave7_models import (  # noqa: F401
    CoEDModel,
    DHNModel,
    GNRFModel,
    GracePOTModel,
    GraceSpcoModel,
    HEATModel,
    NodeIDModel,
    ResidualVectorQuant,
    VectorQuantize,
    grace_pot_bounds,
    odeint_rk4,
)
from gammagl_tpu_torch.models.wave8_models import (  # noqa: F401
    FatraGNNModel,
    GEstimationN,
    GraphEditer,
    modify_structure,
)

# the reference's spellings (gammagl/models/__init__.py)
HPN = HPNModel
HeCo = HeCoModel
Hid_net = HiDNetModel
RoheHAN = RoheHANModel
Specformer = SpecformerModel
MGNNI_m_MLP = MGNNIModel  # the MLP-injection multiscale variant
HEAT = HEATModel
NewGrace = MAGCLModel  # the reference's magcl.py name
NodeIDGNN = NodeIDModel
GNRF = GNRFModel
Graph_Editer = GraphEditer
PreModel = AdaGADModel  # AdaGAD's masked-reconstruction pretrainer
EdgePromptGCNModel = EdgePromptModel

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
           "MGNNI_m_MLP", "SIGNModel", "GCNUniFews", "HardGATConv",
           "HardGATModel", "AdaGADModel", "Sp2GCLModel", "MAGCLModel",
           "GCILModel", "SFGCNModel", "EdgePromptModel", "AMPModel",
           "dfad_generator_loss", "dfad_student_loss", "DHNModel",
           "HEATModel", "CoEDModel", "VectorQuantize",
           "ResidualVectorQuant", "NodeIDModel", "odeint_rk4", "GNRFModel",
           "GracePOTModel", "grace_pot_bounds", "GraceSpcoModel",
           "GEstimationN", "FatraGNNModel", "GraphEditer",
           "modify_structure", "HEAT", "NewGrace", "NodeIDGNN", "GNRF",
           "Graph_Editer", "PreModel", "EdgePromptGCNModel"]
