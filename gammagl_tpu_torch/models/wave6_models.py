"""MAGCL, GCIL, SFGCN (AM-GCN), EdgePrompt, AMP and the DFAD-GNN losses
(counterparts of `gammagl_tpu/models/wave6_models.py`; reference:
gammagl/models/{magcl,gcil,sfgcn,edgeprompt,amp,dfad_gnn}.py).

They take no plan, as in the JAX package: their sums are the port's COO
ops on every device. Each model names its flax counterpart's parameters
in ``flax_tree`` (`utils.load_jax_params`); ``in_channels=None`` leaves
the first maps lazy, as flax infers them.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.conv.simple_convs import _gcn_weights
from gammagl_tpu_torch.layers.conv.wave2_convs import _take
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.models.ssl import _GCNEncoder, grace_loss
from gammagl_tpu_torch.ops import segment_count, segment_sum, spmm

__all__ = ["MAGCLModel", "GCILModel", "SFGCNModel", "EdgePromptModel",
           "AMPModel", "dfad_generator_loss", "dfad_student_loss"]


class MAGCLModel(nn.Module):
    """MA-GCL ("NewGrace", reference magcl.py): GRACE with model
    augmentation. The first view runs a ReLU GCN encoder of ``k_low``
    layers (``_GCNEncoder_0``), the second one of ``k_high`` layers
    (``_GCNEncoder_1``); one projection head (``Dense_0``, ELU,
    ``Dense_1``) and `grace_loss` between them. Without a second view the
    forward returns the first view's embeddings."""

    def __init__(self, hidden_dim=128, tau=0.5, k_low=1, k_high=3,
                 in_channels=None):
        super().__init__()
        self.tau = tau
        self.enc_low = _GCNEncoder(hidden_dim, k_low, act="relu",
                                   in_channels=in_channels)
        self.enc_high = _GCNEncoder(hidden_dim, k_high, act="relu",
                                    in_channels=in_channels)
        self.proj0 = lecun_dense(hidden_dim, hidden_dim)
        self.proj1 = lecun_dense(hidden_dim, hidden_dim)

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc_low, "_GCNEncoder_1": self.enc_high,
                "Dense_0": self.proj0, "Dense_1": self.proj1}

    def project(self, z):
        return lecun_apply(self.proj1, F.elu(lecun_apply(self.proj0, z)))

    def forward(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                num_nodes=None):
        z1 = self.enc_low(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = self.enc_high(x2, ei2, w2, num_nodes)
        return grace_loss(self.project(z1), self.project(z2), self.tau)


class GCILModel(nn.Module):
    """GCIL (Mo 2024; reference gcil.py): one two-layer ReLU GCN encoder
    (``_GCNEncoder_0``) on two views; the loss is Barlow-Twins style: the
    (D, D) cross-correlation of the column-standardised embeddings
    (population std + 1e-6), its diagonal pulled to 1 and its off-diagonal
    entries, weighted ``lambd``, to 0. Without a second view the forward
    returns the first view's embeddings."""

    def __init__(self, hidden_dim=128, lambd=5e-3, in_channels=None):
        super().__init__()
        self.lambd = lambd
        self.enc = _GCNEncoder(hidden_dim, 2, act="relu",
                               in_channels=in_channels)

    def flax_tree(self):
        return {"_GCNEncoder_0": self.enc}

    def forward(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                num_nodes=None):
        z1 = self.enc(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = self.enc(x2, ei2, w2, num_nodes)

        def norm(z):
            return (z - z.mean(0)) / (z.std(0, correction=0) + 1e-6)

        c = norm(z1).T @ norm(z2) / z1.shape[0]
        diag = torch.diagonal(c)
        on_diag = ((diag - 1) ** 2).sum()
        off_diag = (c ** 2).sum() - (diag ** 2).sum()
        return on_diag + self.lambd * off_diag


class SFGCNModel(nn.Module):
    """SFGCN / AM-GCN structure-feature fusion (reference sfgcn.py): two
    GCNs over the topology graph (``topo1``, ReLU, ``topo2``) and over a
    kNN feature graph (``feat1``, ReLU, ``feat2``), a common GCN on each
    graph (``common``, ``common2``, ReLU, averaged), the three channels
    fused by a per-node attention (``Dense_0`` to 16, tanh, ``Dense_1`` to
    one bias-free score, softmax over the channels), then ``Dense_2`` to
    the classes. Returns (logits, the mean squared gap between the two
    common embeddings)."""

    def __init__(self, num_class, hidden_dim=64, in_channels=None):
        super().__init__()
        self.topo1 = GCNConv(in_channels, hidden_dim)
        self.topo2 = GCNConv(hidden_dim, hidden_dim)
        self.feat1 = GCNConv(in_channels, hidden_dim)
        self.feat2 = GCNConv(hidden_dim, hidden_dim)
        self.common = GCNConv(in_channels, hidden_dim)
        self.common2 = GCNConv(in_channels, hidden_dim)
        self.att0 = lecun_dense(hidden_dim, 16)
        self.att1 = lecun_dense(16, 1, bias=False)
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"topo1": self.topo1, "topo2": self.topo2,
                "feat1": self.feat1, "feat2": self.feat2,
                "common": self.common, "common2": self.common2,
                "Dense_0": self.att0, "Dense_1": self.att1,
                "Dense_2": self.head}

    def forward(self, x, edge_index, feat_edge_index, num_nodes=None):
        kw = {"num_nodes": num_nodes}
        h_t = self.topo2(F.relu(self.topo1(x, edge_index, **kw)),
                         edge_index, **kw)
        h_f = self.feat2(F.relu(self.feat1(x, feat_edge_index, **kw)),
                         feat_edge_index, **kw)
        c1 = F.relu(self.common(x, edge_index, **kw))
        c2 = F.relu(self.common2(x, feat_edge_index, **kw))
        h_c = (c1 + c2) / 2
        stack = torch.stack([h_t, h_c, h_f], dim=1)  # (N, 3, D)
        att = torch.tanh(lecun_apply(self.att0, stack))
        att = torch.softmax(lecun_apply(self.att1, att), dim=1)
        logits = lecun_apply(self.head, (stack * att).sum(1))
        return logits, ((c1 - c2) ** 2).mean()


class EdgePromptModel(nn.Module):
    """EdgePrompt (reference edgeprompt.py): learnable prompt vectors
    (``prompts``, (P, D), normal 0.02) added to the messages of an
    encoder (``frozen_enc``); each source mixes the prompts by a softmax of
    ``Dense_0`` of its features. The messages are averaged into each
    destination (its in-degree counted in float32, at least 1), then ReLU
    and ``Dense_1`` to the classes. As in the JAX model, nothing here
    stops the encoder's gradient: a loop that keeps it frozen leaves it out
    of its optimizer."""

    def __init__(self, num_class, hidden_dim=64, num_prompts=4,
                 in_channels=None):
        super().__init__()
        self.prompts = nn.Parameter(torch.randn(num_prompts, hidden_dim)
                                    * 0.02)
        self.frozen_enc = lecun_dense(in_channels, hidden_dim)
        self.select = lecun_dense(in_channels, num_prompts)
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"prompts": self.prompts, "frozen_enc": self.frozen_enc,
                "Dense_0": self.select, "Dense_1": self.head}

    def forward(self, x, edge_index, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        src, dst = edge_index[0], edge_index[1]
        h = lecun_apply(self.frozen_enc, x)
        sel = torch.softmax(lecun_apply(self.select, x), dim=-1)
        msg = _take(h, src) + _take(sel @ self.prompts, src)
        deg = segment_count(dst, num_nodes).to(h.dtype)
        agg = segment_sum(msg, dst, num_nodes) / deg.clamp_min(1)[:, None]
        return lecun_apply(self.head, F.relu(agg))


class AMPModel(nn.Module):
    """Adaptive message passing (reference amp.py): ``Dense_0`` (ReLU),
    then ``max_steps`` propagations by the symmetric GCN norm; after each,
    a node halts with probability sigmoid(``Dense_1``(h) / tau), and the
    output mixes the steps' states by the probability of halting there
    (the last step takes what remains). Returns (``Dense_2`` of the mix,
    the expected depth: the sum over steps of (step + 1) times the mean
    halting weight)."""

    def __init__(self, num_class, hidden_dim=64, max_steps=5, tau=1.0,
                 in_channels=None):
        super().__init__()
        self.max_steps, self.tau = max_steps, tau
        self.lin = lecun_dense(in_channels, hidden_dim)
        self.halt = lecun_dense(hidden_dim, 1)
        self.head = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        return {"Dense_0": self.lin, "Dense_1": self.halt,
                "Dense_2": self.head}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        w = _gcn_weights(edge_index, num_nodes, edge_weight, x.dtype)
        h = F.relu(lecun_apply(self.lin, x))
        acc = torch.zeros_like(h)
        remain = torch.ones((h.shape[0], 1), dtype=h.dtype, device=h.device)
        expected_depth = torch.zeros((), dtype=h.dtype, device=h.device)
        for step in range(self.max_steps):
            h = spmm(edge_index, w, h, num_nodes=num_nodes)
            p = torch.sigmoid(lecun_apply(self.halt, h) / self.tau)
            use = remain if step == self.max_steps - 1 else remain * p
            acc = acc + use * h
            expected_depth = expected_depth + (step + 1) * use.mean()
            remain = remain * (1 - p)
        return lecun_apply(self.head, acc), expected_depth


def dfad_student_loss(student_logits, teacher_logits):
    """DFAD-GNN's student objective (reference dfad_gnn.py): the mean L1
    gap to the teacher's logits, which carry no gradient."""
    return (student_logits - teacher_logits.detach()).abs().mean()


def dfad_generator_loss(student_logits, teacher_logits):
    """DFAD-GNN's generator objective: the negated mean L1 gap (the
    generator seeks disagreement)."""
    return -(student_logits - teacher_logits).abs().mean()
