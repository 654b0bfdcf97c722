"""Self-supervised and contrastive models: DGI, GRACE, MVGRL, InfoGraph,
GGD (counterparts of `gammagl_tpu/models/ssl.py`; reference:
gammagl/models/{dgi,grace,mvgrl,infograph,ggd}.py).

The encoders are `GCNConv` / `GINConv` on the port's COO ops, as in JAX:
the models take no plan, so on the card they launch none of the
hand-written kernels. The augmentations draw from a ``torch.Generator``
(None: the default generator of the tensor's device); each also takes
its draw as an argument (``perm``, ``feat_mask``, ``edge_mask``), so a
caller can replay another stream's draws. Each model names its flax
counterpart's parameters in ``flax_tree`` (`utils.load_jax_params`);
``in_channels=None`` leaves the first map lazy, as flax infers it.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.conv.simple_convs import GINConv
from gammagl_tpu_torch.layers.dense import glorot_uniform_, lecun_dense
from gammagl_tpu_torch.layers.pool import global_sum_pool
from gammagl_tpu_torch.models.simple_models import _Dense

__all__ = ["DGIModel", "GraceModel", "MVGRLModel", "InfoGraph", "GGDModel",
           "grace_loss", "corrupt_features", "drop_edge_and_feature"]


def _draw_device(generator, t):
    return generator.device if generator is not None else t.device


def corrupt_features(x, generator=None, perm=None):
    """Row-shuffle corruption (DGI's negative samples): ``x[perm]``, with
    ``perm`` a permutation of the rows drawn from ``generator`` when not
    given."""
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=generator,
                              device=_draw_device(generator, x))
    return x[perm.to(x.device).long()]


def drop_edge_and_feature(x, edge_index, feat_drop, edge_drop,
                          generator=None, feat_mask=None, edge_mask=None):
    """GRACE's view augmentation: each feature column kept with
    probability 1 - ``feat_drop`` (one (1, F) mask for every row), each
    edge with probability 1 - ``edge_drop``. Returns (masked x, the edge
    mask as weights in x's dtype). The masks are drawn from ``generator``
    when not given (boolean or 0/1)."""
    dev = _draw_device(generator, x)
    if feat_mask is None:
        feat_mask = torch.rand((1, x.shape[1]), generator=generator,
                               device=dev) < 1 - feat_drop
    if edge_mask is None:
        edge_mask = torch.rand(edge_index.shape[1], generator=generator,
                               device=dev) < 1 - edge_drop
    x = x * feat_mask.to(x.device, x.dtype)
    return x, edge_mask.to(x.device, x.dtype)


class _GCNEncoder(nn.Module):
    """``num_layers`` GCNConvs (flax ``GCNConv_{i}``), each followed by a
    PReLU of one learned slope (``prelu_{i}``, shape (1,), 0.25 at init)
    or a ReLU."""

    def __init__(self, hidden_dim, num_layers=1, act="prelu",
                 in_channels=None):
        super().__init__()
        self.act = act
        self.convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else hidden_dim, hidden_dim)
            for i in range(num_layers))
        self.alphas = nn.ParameterList(
            nn.Parameter(torch.full((1,), 0.25)) for _ in range(num_layers)
        ) if act == "prelu" else None

    def flax_tree(self):
        tree = {f"GCNConv_{i}": conv for i, conv in enumerate(self.convs)}
        if self.alphas is not None:
            tree.update({f"prelu_{i}": a for i, a in enumerate(self.alphas)})
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        for i, conv in enumerate(self.convs):
            x = conv(x, edge_index, edge_weight, num_nodes)
            x = (torch.where(x > 0, x, self.alphas[i] * x)
                 if self.alphas is not None else F.relu(x))
        return x


def _disc(hidden_dim):
    """A bilinear discriminator's (hidden, hidden) matrix, glorot-uniform
    as in flax."""
    return nn.Parameter(glorot_uniform_(torch.empty(hidden_dim, hidden_dim)))


def _bce_pair(pos, neg):
    """-(mean log sigmoid(pos) + mean log sigmoid(-neg))."""
    return -(F.logsigmoid(pos).mean() + F.logsigmoid(-neg).mean())


class DGIModel(nn.Module):
    """Deep Graph Infomax (Velickovic 2019; reference dgi.py): local-global
    mutual information with a bilinear discriminator. Without
    ``x_corrupt`` the forward returns the embeddings, else the loss."""

    def __init__(self, hidden_dim=512, in_channels=None):
        super().__init__()
        self.enc = _GCNEncoder(hidden_dim, in_channels=in_channels)
        self.disc = _disc(hidden_dim)

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc, "disc": self.disc}

    def forward(self, x, edge_index, x_corrupt=None, num_nodes=None):
        h_pos = self.enc(x, edge_index, num_nodes=num_nodes)
        if x_corrupt is None:
            return h_pos
        h_neg = self.enc(x_corrupt, edge_index, num_nodes=num_nodes)
        summary = torch.sigmoid(h_pos.mean(0))
        ws = self.disc @ summary
        return _bce_pair(h_pos @ ws, h_neg @ ws)


def grace_loss(z1, z2, tau=0.5):
    """NT-Xent between two views (reference grace.py semi_loss)."""
    z1 = z1 / (torch.linalg.vector_norm(z1, dim=1, keepdim=True) + 1e-12)
    z2 = z2 / (torch.linalg.vector_norm(z2, dim=1, keepdim=True) + 1e-12)

    def semi(a, b):
        intra = torch.exp(a @ a.T / tau)
        inter = torch.exp(a @ b.T / tau)
        pos = torch.diagonal(inter)
        denom = intra.sum(1) - torch.diagonal(intra) + inter.sum(1)
        return -torch.log(pos / denom)

    return 0.5 * (semi(z1, z2) + semi(z2, z1)).mean()


class GraceModel(nn.Module):
    """GRACE (Zhu 2020; reference grace.py): two augmented views through
    one ReLU GCN encoder and one projection head (``Dense_0``, ELU,
    ``Dense_1``), NT-Xent between them. Without the second view the
    forward returns the first view's embeddings."""

    def __init__(self, hidden_dim=128, proj_dim=128, num_layers=2, tau=0.5,
                 in_channels=None):
        super().__init__()
        self.tau = tau
        self.enc = _GCNEncoder(hidden_dim, num_layers, act="relu",
                               in_channels=in_channels)
        self.proj = nn.Sequential(_Dense(hidden_dim, proj_dim), nn.ELU(),
                                  _Dense(proj_dim, hidden_dim))

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc, "Dense_0": self.proj[0].lin,
                "Dense_1": self.proj[2].lin}

    def forward(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                num_nodes=None):
        z1 = self.enc(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = self.enc(x2, ei2, w2, num_nodes)
        return grace_loss(self.proj(z1), self.proj(z2), self.tau)


class MVGRLModel(nn.Module):
    """MVGRL (Hassani 2020; reference mvgrl.py): an adjacency view and a
    diffusion view (its own edges and weights), each with its own
    encoder, contrasted across views by one bilinear discriminator.
    Without ``x_corrupt`` the forward returns the sum of the two views'
    embeddings, else the loss."""

    def __init__(self, hidden_dim=512, in_channels=None):
        super().__init__()
        self.enc_a = _GCNEncoder(hidden_dim, in_channels=in_channels)
        self.enc_d = _GCNEncoder(hidden_dim, in_channels=in_channels)
        self.disc = _disc(hidden_dim)

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc_a, "_GCNEncoder_1": self.enc_d,
                "disc": self.disc}

    def forward(self, x, edge_index, diff_edge_index, diff_weight,
                x_corrupt=None, num_nodes=None):
        h_a = self.enc_a(x, edge_index, num_nodes=num_nodes)
        h_d = self.enc_d(x, diff_edge_index, diff_weight, num_nodes=num_nodes)
        if x_corrupt is None:
            return h_a + h_d
        hn_a = self.enc_a(x_corrupt, edge_index, num_nodes=num_nodes)
        hn_d = self.enc_d(x_corrupt, diff_edge_index, diff_weight,
                          num_nodes=num_nodes)
        ws_a = self.disc @ torch.sigmoid(h_a.mean(0))
        ws_d = self.disc @ torch.sigmoid(h_d.mean(0))
        # cross-view: local of one view vs summary of the other
        return _bce_pair(h_a @ ws_d + h_d @ ws_a, hn_a @ ws_d + hn_d @ ws_a)


class InfoGraph(nn.Module):
    """InfoGraph (Sun 2020; reference infograph.py): ``num_layers``
    GINConvs, each with a two-layer ReLU MLP (flax ``Dense_{2i}``,
    ``Dense_{2i+1}``), the layers' outputs concatenated and sum-pooled by
    ``batch``; node and graph rows projected (``Dense_{2L}``,
    ``Dense_{2L+1}``) and scored against each other, a node's own graph
    the positive. Returns (loss, graph embeddings)."""

    def __init__(self, hidden_dim=32, num_layers=3, in_channels=None):
        super().__init__()
        self.convs = nn.ModuleList(
            GINConv(apply_func=nn.Sequential(
                _Dense(in_channels if i == 0 else hidden_dim, hidden_dim),
                nn.ReLU(), _Dense(hidden_dim, hidden_dim), nn.ReLU()))
            for i in range(num_layers))
        self.proj_n = lecun_dense(num_layers * hidden_dim, hidden_dim)
        self.proj_g = lecun_dense(num_layers * hidden_dim, hidden_dim)

    def flax_tree(self):
        tree = {}
        for i, conv in enumerate(self.convs):
            tree[f"Dense_{2 * i}"] = conv.apply_func[0].lin
            tree[f"Dense_{2 * i + 1}"] = conv.apply_func[2].lin
        n = 2 * len(self.convs)
        tree[f"Dense_{n}"], tree[f"Dense_{n + 1}"] = self.proj_n, self.proj_g
        return tree

    def forward(self, x, edge_index, batch, num_graphs, num_nodes=None):
        hs = []
        for conv in self.convs:
            x = conv(x, edge_index, num_nodes=num_nodes)
            hs.append(x)
        h_node = torch.cat(hs, dim=-1)
        h_graph = global_sum_pool(h_node, batch, num_graphs)
        scores = self.proj_n(h_node) @ self.proj_g(h_graph).T  # (N, G)
        pos_mask = F.one_hot(batch.long(), num_graphs).to(scores.dtype)
        pos = (F.logsigmoid(scores) * pos_mask).sum() / pos_mask.sum()
        neg_mask = 1 - pos_mask
        neg = (F.logsigmoid(-scores) * neg_mask).sum() / neg_mask.sum().clamp(
            min=1)
        return -(pos + neg), h_graph


class GGDModel(nn.Module):
    """Graph Group Discrimination (Zheng 2022; reference ggd.py): the
    encoder, then a map (``Dense_0``); a node's score is the sum of its
    row, clean nodes against corrupted ones. Without ``x_corrupt`` the
    forward returns the mapped embeddings, else the loss."""

    def __init__(self, hidden_dim=512, in_channels=None):
        super().__init__()
        self.enc = _GCNEncoder(hidden_dim, in_channels=in_channels)
        self.proj = lecun_dense(hidden_dim, hidden_dim)

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc, "Dense_0": self.proj}

    def forward(self, x, edge_index, x_corrupt=None, num_nodes=None):
        h_pos = self.proj(self.enc(x, edge_index, num_nodes=num_nodes))
        if x_corrupt is None:
            return h_pos
        h_neg = self.proj(self.enc(x_corrupt, edge_index,
                                   num_nodes=num_nodes))
        return _bce_pair(h_pos.sum(1), h_neg.sum(1))
