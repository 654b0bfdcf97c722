"""The reference's model names: aliases of the port's classes, and the
thin models that have no other home (counterpart of
`gammagl_tpu/models/compat.py`; reference gammagl/models/__init__.py).

The aliases are plain bindings, each name bound once, here. The thin
models are small stacks over the port's convs (AGNN, FiLM, GMM, DNA,
HCHA; GAT on the flash kernels; GNRF's backbone), Sp2GCL's parts, the
probes and heads, SkipGram, GraphGAN's halves, MGNNI's attention variant,
DFAD's student and generator, and two host facades (HERec, TADW). Each
keeps its JAX counterpart's flax names (``flax_tree``), which follow
construction order: where flax builds an outer ``Dense`` before the
inner one it wraps, the outer one is ``Dense_0``. Dropout is flax's
(`layers.dense.dropout`), active in training mode, drawing from
``generator``. Every graph model here is COO, as in JAX, except
`FusedGATModel`, which requires its plan.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import (AGNNConv, DNAConv, FILMConv,
                                           FusedGATConv, GCNConv, GMMConv,
                                           HypergraphConv, MGNNI_m_iter)
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.models.embedding import DeepWalk, Node2Vec
from gammagl_tpu_torch.models.gan_distill import herec
from gammagl_tpu_torch.models.gcn import GCNModel
from gammagl_tpu_torch.models.graphormer import GraphormerModel
from gammagl_tpu_torch.models.graphsage import (GraphSAGEModel,
                                                GraphSAGESampleModel)
from gammagl_tpu_torch.models.heco import HeCoModel
from gammagl_tpu_torch.models.hetero import HANModel, RGCNModel
from gammagl_tpu_torch.models.seal_cogsl import SEALModel
from gammagl_tpu_torch.models.spectral import MGNNIModel, SpecformerModel
from gammagl_tpu_torch.models.wave2_models import CompGCNModel
from gammagl_tpu_torch.models.wave3_models import (GRADEModel, HiDNetModel,
                                                   HPNModel, RoheHANModel,
                                                   tadw)
from gammagl_tpu_torch.models.wave5_models import AdaGADModel
from gammagl_tpu_torch.models.wave6_models import (MAGCLModel,
                                                   EdgePromptModel,
                                                   dfad_generator_loss,
                                                   dfad_student_loss)
from gammagl_tpu_torch.models.wave7_models import (GNRFModel, HEATModel,
                                                   NodeIDModel)
from gammagl_tpu_torch.models.wave8_models import GraphEditer
from gammagl_tpu_torch.utils.degree import degree

__all__ = [
    # pure aliases
    "HEAT", "GraphSAGE_Full_Model", "GraphSAGE_Sample_Model", "RGCN",
    "CompGCN", "HAN", "GRADE", "HPN", "HeCo", "Hid_net", "RoheHAN",
    "Graphormer", "Specformer", "NewGrace", "NodeIDGNN", "GNRF",
    "DeepWalkModel", "Node2vecModel", "Graph_Editer", "DGCNN",
    "PreModel", "EdgePromptGCNModel", "MGNNI_m_MLP",
    # thin real models
    "AGNNModel", "FILMModel", "GMMModel", "DNAModel", "HCHA", "LogReg",
    "SkipGramModel", "HERec", "TADWModel", "MGNNI_m_att", "DFADModel",
    "DFADGenerator", "Generator", "Discriminator", "EigenMLP", "Encoder",
    "SpaSpeNode", "ReModel", "EdgePromptNodeClassifier", "FusedGATModel",
    "GNN", "amp_elbo_regression_loss",
]

# --- pure aliases (the reference's name -> the port's class) -------------
HEAT = HEATModel
GraphSAGE_Full_Model = GraphSAGEModel
GraphSAGE_Sample_Model = GraphSAGESampleModel
RGCN = RGCNModel
CompGCN = CompGCNModel
HAN = HANModel
GRADE = GRADEModel
HPN = HPNModel
HeCo = HeCoModel
Hid_net = HiDNetModel
RoheHAN = RoheHANModel
Graphormer = GraphormerModel
Specformer = SpecformerModel
NewGrace = MAGCLModel                 # the reference's magcl.py name
NodeIDGNN = NodeIDModel
GNRF = GNRFModel
DeepWalkModel = DeepWalk
Node2vecModel = Node2Vec
Graph_Editer = GraphEditer
DGCNN = SEALModel                     # the reference's seal.py exports DGCNN
PreModel = AdaGADModel                # AdaGAD's masked-recon pretrainer
EdgePromptGCNModel = EdgePromptModel
MGNNI_m_MLP = MGNNIModel              # the MLP-injection multiscale variant


def _rate(module, rate):
    return rate if module.training else 0.0


# --- small node-classification stacks over the port's convs --------------
class AGNNModel(nn.Module):
    """AGNN (reference agnn.py): dropout, ``Dense_0`` and ReLU,
    ``n_att_layers`` AGNNConvs, dropout, ``Dense_1``."""

    def __init__(self, num_class, hidden_dim=16, n_att_layers=2,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.convs = nn.ModuleList(AGNNConv() for _ in range(n_att_layers))
        self.lin1 = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.lin0, "Dense_1": self.lin1}
        tree.update({f"AGNNConv_{i}": c for i, c in enumerate(self.convs)})
        return tree

    def forward(self, x, edge_index, num_nodes=None, generator=None):
        rate = _rate(self, self.drop_rate)
        h = F.relu(lecun_apply(self.lin0, dropout(x, rate, generator)))
        for conv in self.convs:
            h = conv(h, edge_index, num_nodes=num_nodes)
        return self.lin1(dropout(h, rate, generator))


class FILMModel(nn.Module):
    """GNN-FiLM (reference film.py): ``num_layers`` FILMConvs of
    ``hidden_dim``, each followed by dropout, and a ``Dense_0`` head."""

    def __init__(self, num_class, hidden_dim=64, num_layers=2,
                 drop_rate=0.1, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        dims = [in_channels] + [hidden_dim] * num_layers
        self.convs = nn.ModuleList(FILMConv(dims[i], hidden_dim)
                                   for i in range(num_layers))
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {f"FILMConv_{i}": c for i, c in enumerate(self.convs)}
        tree["Dense_0"] = self.head
        return tree

    def forward(self, x, edge_index, num_nodes=None, generator=None):
        rate = _rate(self, self.drop_rate)
        h = x
        for conv in self.convs:
            h = dropout(conv(h, edge_index, num_nodes=num_nodes), rate,
                        generator)
        return self.head(h)


class GMMModel(nn.Module):
    """MoNet (reference gmm.py): two GMMConvs on the pseudo-coordinates
    u_ij = (deg_i^-1/2, deg_j^-1/2) of the in-degrees (0 where a degree is
    0), ReLU between."""

    def __init__(self, num_class, hidden_dim=16, kernel_size=3,
                 in_channels=None):
        super().__init__()
        self.convs = nn.ModuleList([
            GMMConv(in_channels, hidden_dim, dim=2, kernel_size=kernel_size),
            GMMConv(hidden_dim, num_class, dim=2, kernel_size=kernel_size)])

    def flax_tree(self):
        return {f"GMMConv_{i}": c for i, c in enumerate(self.convs)}

    def forward(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0].long(), edge_index[1].long()
        deg = degree(dst, num_nodes, dtype=x.dtype)
        dis = torch.where(deg > 0, deg.clamp_min(1e-30) ** -0.5,
                          torch.zeros((), dtype=deg.dtype,
                                      device=deg.device))
        last = num_nodes - 1
        pseudo = torch.stack([dis[src.clamp(0, last)],
                              dis[dst.clamp(0, last)]], -1)
        h = F.relu(self.convs[0](x, edge_index, pseudo, num_nodes=num_nodes))
        return self.convs[1](h, edge_index, pseudo, num_nodes=num_nodes)


class DNAModel(nn.Module):
    """DNA (reference dna.py): dropout, ``Dense_0`` and ReLU, then
    ``num_layers`` DNAConvs each over the stack of every representation so
    far, dropout of the last, ``Dense_1``."""

    def __init__(self, num_class, hidden_dim=64, num_layers=3, heads=1,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.convs = nn.ModuleList(DNAConv(hidden_dim, heads=heads)
                                   for _ in range(num_layers))
        self.lin1 = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.lin0, "Dense_1": self.lin1}
        tree.update({f"DNAConv_{i}": c for i, c in enumerate(self.convs)})
        return tree

    def forward(self, x, edge_index, num_nodes=None, generator=None):
        rate = _rate(self, self.drop_rate)
        h = F.relu(lecun_apply(self.lin0, dropout(x, rate, generator)))
        x_all = h[:, None]
        for conv in self.convs:
            h = conv(x_all, edge_index, num_nodes=num_nodes)
            x_all = torch.cat([x_all, h[:, None]], dim=1)
        return self.lin1(dropout(x_all[:, -1], rate, generator))


class HCHA(nn.Module):
    """Hypergraph convolution with attention (reference hcha.py): two
    HypergraphConvs, ReLU between."""

    def __init__(self, num_class, hidden_dim=64, in_channels=None):
        super().__init__()
        self.convs = nn.ModuleList([HypergraphConv(in_channels, hidden_dim),
                                    HypergraphConv(hidden_dim, num_class)])

    def flax_tree(self):
        return {f"HypergraphConv_{i}": c for i, c in enumerate(self.convs)}

    def forward(self, x, hyperedge_index, hyperedge_weight=None,
                num_nodes=None, num_edges=None):
        h = F.relu(self.convs[0](x, hyperedge_index, hyperedge_weight,
                                 num_nodes, num_edges))
        return self.convs[1](h, hyperedge_index, hyperedge_weight,
                             num_nodes, num_edges)


class FusedGATModel(nn.Module):
    """GAT pinned to the fused flash-attention kernels (reference
    fusedgat.py wraps dgNN): two `FusedGATConv` (``heads`` of
    ``hidden_dim``, ELU, then one head of ``num_class`` averaged), input
    dropout before each, no attention dropout (as in JAX). Build the plan
    once with ``FusedGATModel.to_graph_format`` and pass it to every
    call; without it the forward raises ValueError."""

    to_graph_format = staticmethod(FusedGATConv.to_graph_format)

    def __init__(self, hidden_dim=8, num_class=7, heads=8, drop_rate=0.6,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList([
            FusedGATConv(in_channels, hidden_dim, heads=heads),
            FusedGATConv(hidden_dim * heads, num_class, heads=1,
                         concat=False)])

    def flax_tree(self):
        return {f"FusedGATConv_{i}": c for i, c in enumerate(self.convs)}

    def forward(self, x, edge_index, plan=None, num_nodes=None,
                generator=None):
        rate = _rate(self, self.drop_rate)
        h = self.convs[0](dropout(x, rate, generator), edge_index, num_nodes,
                          plan=plan)
        h = F.elu(h)
        return self.convs[1](dropout(h, rate, generator), edge_index,
                             num_nodes, plan=plan)


# --- probes / heads ---------------------------------------------------------
class LogReg(nn.Module):
    """Logistic-regression probe (reference gcil.py LogReg): ``Dense_0``."""

    def __init__(self, out_dim, in_channels=None):
        super().__init__()
        self.lin = lecun_dense(in_channels, out_dim)

    def flax_tree(self):
        return {"Dense_0": self.lin}

    def forward(self, x):
        return lecun_apply(self.lin, x)


class EdgePromptNodeClassifier(nn.Module):
    """Head over frozen prompted embeddings (reference edgeprompt.py):
    ``Dense_1`` (to ``hidden_dim``), ReLU, ``Dense_0`` (flax builds the
    outer map first)."""

    def __init__(self, num_class, hidden_dim=64, in_channels=None):
        super().__init__()
        self.inner = lecun_dense(in_channels, hidden_dim)
        self.outer = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"Dense_0": self.outer, "Dense_1": self.inner}

    def forward(self, h):
        return self.outer(F.relu(lecun_apply(self.inner, h)))


class ReModel(nn.Module):
    """AdaGAD's retraining-stage scorer (reference adagad.py ReModel):
    the per-view reconstruction errors (N, K) mixed by softmax(``mix``),
    ``mix`` ones at init."""

    def __init__(self, num_views=None):
        super().__init__()
        self.mix = (nn.parameter.UninitializedParameter() if num_views is None
                    else nn.Parameter(torch.ones(num_views)))

    def flax_tree(self):
        return {"mix": self.mix}

    def forward(self, errors):
        if isinstance(self.mix, nn.parameter.UninitializedParameter):
            with torch.no_grad():
                self.mix.materialize((errors.shape[-1],))
                self.mix.fill_(1.0)
        return errors @ torch.softmax(self.mix, dim=0)


# --- embedding-table models -------------------------------------------------
class SkipGramModel(nn.Module):
    """Skip-gram over random walks (reference skipgram.py): each walk's
    start against the rest, BCE on embedding dot products of positive
    walks and negative ones (flax ``Embed_0``, normal(1) at init)."""

    def __init__(self, num_nodes, embedding_dim=128, eps=1e-15):
        super().__init__()
        self.eps = eps
        self.emb = nn.Embedding(num_nodes, embedding_dim)

    def flax_tree(self):
        return {"Embed_0": self.emb}

    def _walk_loss(self, rw, positive):
        rw = rw.long()
        h_start = self.emb(rw[:, 0])[:, None]
        h_rest = self.emb(rw[:, 1:])
        p = torch.sigmoid((h_start * h_rest).sum(-1).reshape(-1))
        p = p if positive else 1.0 - p
        return -torch.log(p + self.eps).mean()

    def forward(self, pos_rw, neg_rw):
        return self._walk_loss(pos_rw, True) + self._walk_loss(neg_rw, False)


class _EdgeScores(nn.Module):
    """GraphGAN's half: an embedding table ``emb`` (normal(0.1)) and a
    per-node ``bias`` (zeros); score(u, v) = <emb[u], emb[v]> + bias[v]."""

    def __init__(self, num_nodes, embedding_dim=64):
        super().__init__()
        self.emb = nn.Parameter(torch.randn(num_nodes, embedding_dim) * 0.1)
        self.bias = nn.Parameter(torch.zeros(num_nodes))

    def flax_tree(self):
        return {"emb": self.emb, "bias": self.bias}

    def score(self, u, v):
        u, v = u.long(), v.long()
        return (self.emb[u] * self.emb[v]).sum(-1) + self.bias[v]


class Generator(_EdgeScores):
    """GraphGAN's generator half (reference graphgan_generator.py): the
    policy-gradient loss -mean(log sigmoid(score) * reward), the reward a
    constant (``reward.detach()``, JAX's ``stop_gradient``)."""

    def forward(self, u, v, reward):
        return -(F.logsigmoid(self.score(u, v)) * reward.detach()).mean()


class Discriminator(_EdgeScores):
    """GraphGAN's discriminator half (reference
    graphgan_discriminator.py): sigmoid BCE of the edge scores against
    the labels; ``reward`` is log(1 + exp(score)) as written (it
    overflows to inf at large scores, as JAX's does)."""

    def reward(self, u, v):
        return torch.log1p(torch.exp(self.score(u, v)))

    def forward(self, u, v, label):
        return F.binary_cross_entropy_with_logits(self.score(u, v),
                                                  label.float())


# --- Sp2GCL's parts (reference sp2gcl.py) -----------------------------------
class Encoder(nn.Module):
    """Sp2GCL's spatial encoder: two GCNConvs of ``hidden_dim``, ReLU
    between."""

    def __init__(self, hidden_dim=64, in_channels=None):
        super().__init__()
        self.convs = nn.ModuleList([GCNConv(in_channels, hidden_dim),
                                    GCNConv(hidden_dim, hidden_dim)])

    def flax_tree(self):
        return {f"GCNConv_{i}": c for i, c in enumerate(self.convs)}

    def forward(self, x, edge_index, num_nodes=None):
        h = F.relu(self.convs[0](x, edge_index, num_nodes=num_nodes))
        return self.convs[1](h, edge_index, num_nodes=num_nodes)


class EigenMLP(nn.Module):
    """Sp2GCL's spectral encoder: sines and cosines of eigval * 2^(k-1) * pi
    for k = 1..``period`` (multiplied in that order, as in JAX), mapped by
    ``Dense_1`` (inner), ReLU, ``Dense_0`` (outer) to per-eigenvector
    weights; the eigenvectors times them, ReLU, ``Dense_2``."""

    def __init__(self, hidden_dim=64, period=16):
        super().__init__()
        self.period = period
        self.inner = lecun_dense(2 * period, hidden_dim)
        self.outer = lecun_dense(hidden_dim, hidden_dim)
        self.out = lecun_dense(hidden_dim, hidden_dim)

    def flax_tree(self):
        return {"Dense_0": self.outer, "Dense_1": self.inner,
                "Dense_2": self.out}

    def forward(self, eigvecs, eigvals):
        k = torch.arange(1, self.period + 1, dtype=eigvals.dtype,
                         device=eigvals.device)
        ang = eigvals[:, None] * (2.0 ** (k - 1)) * np.pi     # (K, P)
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        lam = self.outer(F.relu(self.inner(pe)))               # (K, H)
        return self.out(F.relu(eigvecs @ lam))


class SpaSpeNode(nn.Module):
    """Sp2GCL's pair: the spatial `Encoder` and the spectral `EigenMLP`
    views through one projection head (``Dense_0``, ELU, ``Dense_1``);
    returns (h_spatial, h_spectral)."""

    def __init__(self, hidden_dim=64, period=16, in_channels=None):
        super().__init__()
        self.spa = Encoder(hidden_dim, in_channels)
        self.spe = EigenMLP(hidden_dim, period)
        self.proj0 = lecun_dense(hidden_dim, hidden_dim)
        self.proj1 = lecun_dense(hidden_dim, hidden_dim)

    def flax_tree(self):
        return {"Encoder_0": self.spa, "EigenMLP_0": self.spe,
                "Dense_0": self.proj0, "Dense_1": self.proj1}

    def _proj(self, h):
        return self.proj1(F.elu(self.proj0(h)))

    def forward(self, x, edge_index, eigvecs, eigvals, num_nodes=None):
        spa = self.spa(x, edge_index, num_nodes)
        spe = self.spe(eigvecs, eigvals)
        return self._proj(spa), self._proj(spe)


# --- MGNNI's attention variant -----------------------------------------------
class MGNNI_m_att(nn.Module):
    """MGNNI with attention over scales (reference mgnni.py MGNNI_m_att):
    ``Dense_0`` to ``hidden_dim``, one `MGNNI_m_iter` equilibrium a scale,
    softmax attention over the scales (``Dense_2`` inner, tanh,
    ``Dense_1`` outer to one score), ``Dense_3`` head."""

    def __init__(self, num_class, hidden_dim=64, scales=(1, 2), gamma=0.8,
                 iters=10, in_channels=None):
        super().__init__()
        self.fx = lecun_dense(in_channels, hidden_dim)
        self.iters = nn.ModuleList(
            MGNNI_m_iter(hidden_dim, k=m, gamma=gamma, max_iter=iters)
            for m in scales)
        self.att_outer = lecun_dense(hidden_dim, 1)
        self.att_inner = lecun_dense(hidden_dim, hidden_dim)
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.fx, "Dense_1": self.att_outer,
                "Dense_2": self.att_inner, "Dense_3": self.head}
        tree.update({f"MGNNI_m_iter_{i}": m
                     for i, m in enumerate(self.iters)})
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        fx = lecun_apply(self.fx, x)
        z = torch.stack([it(fx, edge_index, edge_weight, num_nodes)
                         for it in self.iters], dim=1)      # (N, S, H)
        att = self.att_outer(torch.tanh(self.att_inner(z)))
        z = (torch.softmax(att, dim=1) * z).sum(1)
        return self.head(z)


# --- DFAD (data-free adversarial distillation) -------------------------------
class DFADModel(nn.Module):
    """DFAD's student (reference dfad.py DFADModel): a `GCNModel`
    (``GCNModel_0``) trained from teacher logits by L1 (`student_loss`)."""

    def __init__(self, num_class, hidden_dim=64):
        super().__init__()
        self.gcn = GCNModel(hidden_dim=hidden_dim, num_class=num_class)

    def flax_tree(self):
        return {"GCNModel_0": self.gcn}

    def forward(self, x, edge_index, num_nodes=None):
        return self.gcn(x, edge_index, num_nodes=num_nodes)

    @staticmethod
    def student_loss(student_logits, teacher_logits):
        return dfad_student_loss(student_logits, teacher_logits)


class DFADGenerator(nn.Module):
    """DFAD's graph generator (reference dfad.py DFADGenerator): noise (B,
    Z) -> ReLU(``Dense_0``) -> node features (``Dense_1``, (B, N, F)) and a
    symmetric soft adjacency sigmoid((a + a^T) / 2) (``Dense_2``, (B, N,
    N))."""

    def __init__(self, num_nodes_out, feat_dim, hidden_dim=128,
                 in_channels=None):
        super().__init__()
        self.n, self.f = num_nodes_out, feat_dim
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.lin1 = lecun_dense(hidden_dim, num_nodes_out * feat_dim)
        self.lin2 = lecun_dense(hidden_dim, num_nodes_out * num_nodes_out)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1,
                "Dense_2": self.lin2}

    def forward(self, z):
        h = F.relu(lecun_apply(self.lin0, z))
        feats = self.lin1(h).reshape(-1, self.n, self.f)
        a = self.lin2(h).reshape(-1, self.n, self.n)
        return feats, torch.sigmoid((a + a.transpose(1, 2)) / 2)

    @staticmethod
    def generator_loss(student_logits, teacher_logits):
        return dfad_generator_loss(student_logits, teacher_logits)


# --- GNRF's backbone ---------------------------------------------------------
class GNN(nn.Module):
    """GNRF's plain GNN backbone (reference gnrf.py GNN): ``Dense_0`` in
    (with ``use_mlp_in`` ReLU and ``Dense_1`` after it), ``num_layers``
    residual GCNConvs h + ReLU(conv(h)), a ``Dense`` head."""

    def __init__(self, num_class, hidden_dim=64, num_layers=2,
                 use_mlp_in=False, in_channels=None):
        super().__init__()
        self.use_mlp_in = use_mlp_in
        self.lin_in = lecun_dense(in_channels, hidden_dim)
        self.mlp_in = lecun_dense(hidden_dim, hidden_dim) if use_mlp_in \
            else None
        self.convs = nn.ModuleList(GCNConv(hidden_dim, hidden_dim)
                                   for _ in range(num_layers))
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {"Dense_0": self.lin_in}
        if self.mlp_in is not None:
            tree["Dense_1"] = self.mlp_in
        tree[f"Dense_{len(tree)}"] = self.head
        tree.update({f"GCNConv_{i}": c for i, c in enumerate(self.convs)})
        return tree

    def forward(self, x, edge_index, num_nodes=None):
        h = lecun_apply(self.lin_in, x)
        if self.mlp_in is not None:
            h = self.mlp_in(F.relu(h))
        for conv in self.convs:
            h = h + F.relu(conv(h, edge_index, num_nodes=num_nodes))
        return self.head(h)


# --- host-side embedding facades ---------------------------------------------
class HERec:
    """HERec (reference herec.py): metapath2vec embeddings fused for
    recommendation; a class facade over `herec` (host numpy)."""

    def __init__(self, dim=64):
        self.dim = dim
        self.embeddings = None

    def fit(self, metapath_embeddings, ratings=None):
        self.embeddings = herec(metapath_embeddings, ratings=ratings,
                                dim=self.dim)
        return self.embeddings


class TADWModel:
    """TADW (reference tadw.py TADWModel): text-associated DeepWalk by
    matrix factorisation; a class facade over `tadw` (its steps run on
    ``device``: None the card, ``"cpu"`` the host)."""

    def __init__(self, dim=80, lam=0.2, iters=20, lr=0.01, seed=0,
                 device=None):
        self.kw = dict(dim=dim, lam=lam, iters=iters, lr=lr, seed=seed,
                       device=device)
        self.embeddings = None

    def fit(self, adj, text_features):
        self.embeddings = tadw(np.asarray(adj), np.asarray(text_features),
                               **self.kw)
        return self.embeddings


# --- AMP's ELBO loss ---------------------------------------------------------
def amp_elbo_regression_loss(output_state, targets, log_p_theta_hidden,
                             log_p_theta_output, log_p_L, entropy_qL,
                             qL_probs, n_obs):
    """Negative ELBO for AMP graph regression (reference amp.py:122-163).

    output_state: (num_graphs, num_layers, dim_target) per-depth
    predictions (or (num_graphs, num_layers)); targets (num_graphs,) or
    (num_graphs, dim_target); qL_probs (1, num_layers) the variational
    depth distribution. Tensors or arrays (moved to output_state's
    device, float32)."""
    output_state = torch.as_tensor(output_state)
    dev = output_state.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    targets = t(targets)
    if targets.dim() == 1:
        targets = targets[:, None]
    if output_state.dim() == 2:
        output_state = output_state[..., None]
    n_obs = t(n_obs).float()
    se = ((output_state - targets[:, None, :]) ** 2).sum(-1)
    log_p_y = (-se.mean(0) / 2.0 * n_obs)[None, :]            # (1, L)
    elbo = (log_p_y + t(log_p_theta_hidden) + t(log_p_theta_output)
            + t(log_p_L))
    elbo = (elbo * t(qL_probs)).sum(1) + t(entropy_qL)
    return -(elbo / n_obs).mean()
