"""Graph autoencoders: GAE and VGAE (Kipf 2016), counterparts of
`gammagl_tpu/models/autoencoder.py` (reference: gammagl/models/vgae.py:
a GCN encoder, an inner-product decoder, reconstruction and KL losses).

The encoders are `GCNConv`s on the port's COO ops, as in JAX (no plan).
VGAE's reparameterisation noise is drawn from a ``torch.Generator``, or
handed in as a tensor (``noise``) to replay another stream's draw.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv

__all__ = ["GAEModel", "VGAEModel", "inner_product_decoder", "recon_loss"]


def inner_product_decoder(z, edge_index, sigmoid=True):
    """Each edge's score: the dot of its endpoints' rows of ``z``, through
    a sigmoid unless ``sigmoid=False``."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    val = (z[src] * z[dst]).sum(-1)
    return torch.sigmoid(val) if sigmoid else val


def recon_loss(z, pos_edge_index, neg_edge_index):
    """Binary cross-entropy of the decoder's logits: the positive edges
    against 1, the negative ones against 0, each side a mean."""
    pos = inner_product_decoder(z, pos_edge_index, sigmoid=False)
    neg = inner_product_decoder(z, neg_edge_index, sigmoid=False)
    return -F.logsigmoid(pos).mean() - F.logsigmoid(-neg).mean()


class GAEModel(nn.Module):
    """Two GCNConvs (flax ``GCNConv_0``, ``GCNConv_1``) with a ReLU
    between: the node embeddings."""

    def __init__(self, hidden_dim=32, latent_dim=16, in_channels=None):
        super().__init__()
        self.conv0 = GCNConv(in_channels, hidden_dim)
        self.conv1 = GCNConv(hidden_dim, latent_dim)

    def flax_tree(self):
        return {"GCNConv_0": self.conv0, "GCNConv_1": self.conv1}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        h = F.relu(self.conv0(x, edge_index, edge_weight, num_nodes))
        return self.conv1(h, edge_index, edge_weight, num_nodes)


class VGAEModel(nn.Module):
    """A ReLU GCNConv (``GCNConv_0``), then the mean (``GCNConv_1``) and
    the log standard deviation (``GCNConv_2``, clipped to [-10, 10]).
    Returns (mu, logstd, z): z = mu + exp(logstd) * noise, the noise
    ``noise`` or a unit normal drawn from ``generator``; with neither,
    z = mu (the eval embedding)."""

    def __init__(self, hidden_dim=32, latent_dim=16, in_channels=None):
        super().__init__()
        self.conv0 = GCNConv(in_channels, hidden_dim)
        self.conv_mu = GCNConv(hidden_dim, latent_dim)
        self.conv_logstd = GCNConv(hidden_dim, latent_dim)

    def flax_tree(self):
        return {"GCNConv_0": self.conv0, "GCNConv_1": self.conv_mu,
                "GCNConv_2": self.conv_logstd}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                generator=None, noise=None):
        h = F.relu(self.conv0(x, edge_index, edge_weight, num_nodes))
        mu = self.conv_mu(h, edge_index, edge_weight, num_nodes)
        logstd = self.conv_logstd(h, edge_index, edge_weight, num_nodes)
        logstd = logstd.clamp(-10, 10)
        if noise is None and generator is None:
            return mu, logstd, mu
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=generator.device)
        return mu, logstd, mu + torch.exp(logstd) * noise.to(mu.device,
                                                            mu.dtype)

    @staticmethod
    def kl_loss(mu, logstd):
        """KL divergence of N(mu, exp(logstd)^2) from N(0, 1), summed over
        the latent axis and averaged over the nodes."""
        return -0.5 * torch.mean(torch.sum(
            1 + 2 * logstd - mu ** 2 - torch.exp(2 * logstd), dim=1))
