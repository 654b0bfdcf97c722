"""Convolution layers."""

from gammagl_tpu_torch.layers.conv.message_passing import (  # noqa: F401
    MessagePassing,
)
from gammagl_tpu_torch.layers.conv.gcn_conv import GCNConv  # noqa: F401
from gammagl_tpu_torch.layers.conv.gat_conv import (  # noqa: F401
    GATConv,
    GATV2Conv,
)
from gammagl_tpu_torch.layers.conv.sage_conv import SAGEConv  # noqa: F401
from gammagl_tpu_torch.layers.conv.rgcn_conv import RGCNConv  # noqa: F401
from gammagl_tpu_torch.layers.conv.hetero_conv import (  # noqa: F401
    HANConv,
    HeteroConv,
    HGTConv,
    SimpleHGNConv,
)
from gammagl_tpu_torch.layers.conv.simple_convs import (  # noqa: F401
    AGNNConv,
    APPNPConv,
    ChebConv,
    FAGCNConv,
    GCNIIConv,
    GINConv,
    GPRConv,
    JumpingKnowledge,
    MixHopConv,
    SGConv,
)
from gammagl_tpu_torch.layers.conv.hetero_wave2 import (  # noqa: F401
    HidConv,
    HPNConv,
    RoheHANConv,
    ieHGCNConv,
)
from gammagl_tpu_torch.layers.conv.wave2_convs import (  # noqa: F401
    CompConv,
    DNAConv,
    EdgeConv,
    FILMConv,
    GaANConv,
    GMMConv,
    HypergraphConv,
    PNAConv,
)

# the reference's spelling (gammagl/layers/conv/__init__.py)
Hid_conv = HidConv

__all__ = ["MessagePassing", "GCNConv", "GATConv", "GATV2Conv", "SAGEConv",
           "RGCNConv", "HeteroConv", "HANConv", "HGTConv", "SimpleHGNConv",
           "SGConv", "GINConv", "APPNPConv", "GCNIIConv", "ChebConv",
           "AGNNConv", "FAGCNConv", "GPRConv", "MixHopConv",
           "JumpingKnowledge", "HPNConv", "ieHGCNConv", "HidConv",
           "RoheHANConv", "Hid_conv", "PNAConv", "FILMConv", "EdgeConv",
           "GMMConv", "CompConv", "GaANConv", "DNAConv", "HypergraphConv"]
