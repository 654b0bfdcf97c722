"""GraphGAN, HERec, and GNN-to-MLP distillation (GLNN / LTD-style)
(counterpart of `gammagl_tpu/models/gan_distill.py`).

Reference: gammagl/models/{graphgan,herec}.py and the example-only
distillation trainers (examples/glnn, examples/ltd).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense

__all__ = ["GraphGAN", "herec", "distill_loss", "GLNNStudent"]


class GraphGAN(nn.Module):
    """GraphGAN (Wang et al. 2018; reference graphgan.py): generator and
    discriminator embedding tables (flax ``gen_emb``, ``dis_emb``: normal,
    std 0.1) and per-node biases (``gen_bias``, ``dis_bias``: zeros),
    trained adversarially over sampled (node, neighbour) pairs."""

    def __init__(self, num_nodes, embedding_dim=64):
        super().__init__()
        self.gen_emb = nn.Parameter(0.1 * torch.randn(num_nodes,
                                                      embedding_dim))
        self.gen_bias = nn.Parameter(torch.zeros(num_nodes))
        self.dis_emb = nn.Parameter(0.1 * torch.randn(num_nodes,
                                                      embedding_dim))
        self.dis_bias = nn.Parameter(torch.zeros(num_nodes))

    def flax_tree(self):
        return {"gen_emb": self.gen_emb, "gen_bias": self.gen_bias,
                "dis_emb": self.dis_emb, "dis_bias": self.dis_bias}

    def gen_score(self, u, v):
        return (self.gen_emb[u] * self.gen_emb[v]).sum(-1) + self.gen_bias[v]

    def dis_score(self, u, v):
        return (self.dis_emb[u] * self.dis_emb[v]).sum(-1) + self.dis_bias[v]

    def discriminator_loss(self, u, v, label):
        """Binary cross-entropy of the discriminator's scores: ``label`` 1
        for true edges, 0 for generator samples."""
        return F.binary_cross_entropy_with_logits(
            self.dis_score(u, v), label.to(self.dis_emb.dtype))

    def generator_loss(self, u, v):
        """Policy-gradient style: reward log(1 + exp(D)) (reference
        graphgan reward), held fixed, times the generator's log-sigmoid
        score. The reward is ``log1p(exp(s))`` as in the JAX package, not
        a softplus: it is inf past s ~ 88 in float32, and so the loss."""
        reward = torch.log1p(torch.exp(self.dis_score(u, v))).detach()
        logp = F.logsigmoid(self.gen_score(u, v))
        return -(logp * reward).mean()

    def forward(self, u, v, label=None):
        if label is None:
            return self.generator_loss(u, v)
        return self.discriminator_loss(u, v, label)


def herec(metapath_embeddings, ratings=None, dim=None):
    """HERec fusion (Shi et al. 2018; reference herec.py): the per-metapath
    embeddings and their mean, concatenated (the simple fusion variant);
    the rating model downstream is the caller's. Numpy in, numpy out."""
    embs = [np.asarray(e.detach().cpu() if hasattr(e, "detach") else e)
            for e in metapath_embeddings]
    mean = np.mean(np.stack(embs, 0), axis=0)
    return np.concatenate(embs + [mean], axis=1)


def _soft_cross_entropy(logits, target_probs):
    """optax's ``softmax_cross_entropy``: -sum(p * log_softmax(logits))
    over the last axis."""
    return -(target_probs * F.log_softmax(logits, -1)).sum(-1)


def distill_loss(student_logits, teacher_logits, labels, train_mask,
                 lam=0.5, temperature=1.0):
    """GLNN objective (Zhang et al. 2022): cross-entropy on the labeled
    nodes plus the teacher's tempered soft labels everywhere,
    ``lam * ce + (1 - lam) * kl * t**2``."""
    t = temperature
    ce = F.cross_entropy(student_logits, labels.long(), reduction="none")
    mask = train_mask.to(ce.dtype)
    ce = (ce * mask).sum() / torch.clamp(mask.sum(), min=1)
    kl = _soft_cross_entropy(student_logits / t,
                             F.softmax(teacher_logits / t, -1)).mean()
    return lam * ce + (1 - lam) * kl * t * t


class GLNNStudent(nn.Module):
    """MLP student distilled from a GNN teacher (reference examples/glnn):
    ``num_layers - 1`` maps to ``hidden_dim`` with ReLU and dropout, then
    one to ``num_class`` (flax ``Dense_0`` ...). Dropout is active in
    training mode, drawn from ``generator`` when given."""

    def __init__(self, hidden_dim=128, num_class=7, num_layers=2,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        dims = [in_channels] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.lins = nn.ModuleList(lecun_dense(a, b)
                                  for a, b in zip(dims, dims[1:]))
        self.drop_rate = drop_rate

    def flax_tree(self):
        return {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}

    def forward(self, x, generator=None):
        for lin in self.lins[:-1]:
            x = F.relu(lecun_apply(lin, x))
            if self.training:
                x = dropout(x, self.drop_rate, generator)
        return lecun_apply(self.lins[-1], x)
