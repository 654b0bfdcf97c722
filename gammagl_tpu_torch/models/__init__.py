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
    CAGCNModel,
    GNNLFHFModel,
    GRADEModel,
    HiDNetModel,
    HPNModel,
    MERITModel,
    RoheHANModel,
    SGFormerModel,
    ieHGCNModel,
    tadw,
)
from gammagl_tpu_torch.models.graphormer import GraphormerModel  # noqa: F401
from gammagl_tpu_torch.models.rgt import (  # noqa: F401
    RGTModel,
    rgt_cl_loss,
    rgt_loss,
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
from gammagl_tpu_torch.models.embedding import (  # noqa: F401
    DeepWalk,
    MetaPath2Vec,
    Node2Vec,
)
from gammagl_tpu_torch.models.gan_distill import (  # noqa: F401
    GLNNStudent,
    GraphGAN,
    distill_loss,
    herec,
)
from gammagl_tpu_torch.models.seal_cogsl import (  # noqa: F401
    CoGSLModel,
    SEALModel,
    drnl_node_labeling,
)
from gammagl_tpu_torch.models.defog import (  # noqa: F401
    DeFoGModel,
    XEyTransformerLayer,
    euler_sample_step,
    flow_interpolate,
    timestep_embedding,
)

from gammagl_tpu_torch.models.graph_llm import (  # noqa: F401
    GraphLlamaAdapter,
    GraphLlamaLM,
    GraphTextCLIP,
    LLaGAEncoder,
    LLaGAProjector,
    TinyCausalLM,
    build_stage2_batch,
    llaga_hop_field,
    llaga_neighborhood_detail,
    splice_graph_embeddings,
)
from gammagl_tpu_torch.models.compat import (  # noqa: F401
    # the reference's spellings (gammagl/models/__init__.py)
    HEAT, GraphSAGE_Full_Model, GraphSAGE_Sample_Model, RGCN, CompGCN,
    HAN, GRADE, HPN, HeCo, Hid_net, RoheHAN, Graphormer, Specformer,
    NewGrace, NodeIDGNN, GNRF, DeepWalkModel, Node2vecModel, Graph_Editer,
    DGCNN, PreModel, EdgePromptGCNModel, MGNNI_m_MLP, AGNNModel,
    FILMModel, GMMModel, DNAModel, HCHA, LogReg, SkipGramModel, HERec,
    TADWModel, MGNNI_m_att, DFADModel, DFADGenerator, Generator,
    Discriminator, EigenMLP, Encoder, SpaSpeNode, ReModel,
    EdgePromptNodeClassifier, FusedGATModel, GNN,
    amp_elbo_regression_loss)

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
           "Graph_Editer", "PreModel", "EdgePromptGCNModel",
           "SGFormerModel", "GNNLFHFModel", "CAGCNModel", "MERITModel",
           "GRADEModel", "tadw", "GraphormerModel", "RGTModel", "rgt_loss",
           "rgt_cl_loss", "DeepWalk", "Node2Vec", "MetaPath2Vec",
           "GraphGAN", "herec", "distill_loss", "GLNNStudent",
           "drnl_node_labeling", "SEALModel", "CoGSLModel", "DeFoGModel",
           "XEyTransformerLayer", "timestep_embedding", "flow_interpolate",
           "euler_sample_step",
           # models/compat.py: the reference's spellings and thin models
           "GraphSAGE_Full_Model", "GraphSAGE_Sample_Model", "RGCN",
           "CompGCN", "HAN", "GRADE", "Graphormer", "DeepWalkModel",
           "Node2vecModel", "DGCNN", "AGNNModel", "FILMModel", "GMMModel",
           "DNAModel", "HCHA", "LogReg", "SkipGramModel", "HERec",
           "TADWModel", "MGNNI_m_att", "DFADModel", "DFADGenerator",
           "Generator", "Discriminator", "EigenMLP", "Encoder", "SpaSpeNode",
           "ReModel", "EdgePromptNodeClassifier", "FusedGATModel", "GNN",
           "amp_elbo_regression_loss",
           # models/graph_llm.py
           "GraphTextCLIP", "GraphLlamaAdapter", "LLaGAEncoder",
           "splice_graph_embeddings", "TinyCausalLM", "GraphLlamaLM",
           "build_stage2_batch", "llaga_hop_field",
           "llaga_neighborhood_detail", "LLaGAProjector"]
