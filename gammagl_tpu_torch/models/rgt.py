"""RGT, the Riemannian Graph Transformer over product manifolds
(counterpart of `gammagl_tpu/models/rgt.py`; reference:
gammagl/models/rgt.py).

Three node representations (Euclidean, hyperboloid, sphere) are refined
by structure learners (BFS trees on H, cycles on S, BFS sequences on E),
exchanged through tangent projections and vector-quantised; training is
self-supervised (commitment plus cross-view InfoNCE). One `nan_to_num` on
the projected tokens, as in JAX; the reference's host-side NaN checks are
not brought back. The structure buffers come padded from
`loader.ExtractNodeLoader`. No kernel: the learners' softmax and sums are
the port's COO ops, as in JAX. Dropout acts only in a call that is not
``deterministic`` (the JAX flag), drawing from ``generator``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.attention.rgt import (
    EuclideanStructureLearner, HyperbolicStructureLearner,
    SphericalStructureLearner)
from gammagl_tpu_torch.layers.conv.rgt_layers import (EuclideanEncoder,
                                                      ManifoldEncoder)
from gammagl_tpu_torch.layers.conv.rgt_vq import (VectorQuantizeE,
                                                  VectorQuantizeR)
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.utils.manifold_math import EuclideanM, LorentzM, SphereM

__all__ = ["RGTModel", "rgt_loss", "rgt_cl_loss"]


class InitBlock(nn.Module):
    """Tokens -> the (E, H, S) triple: ``euc_init``, ``hyp_init``,
    ``sph_init``."""

    def __init__(self, manifold_H, manifold_S, in_dim, hidden_dim, out_dim,
                 dropout=0.1):
        super().__init__()
        self.euc_init = EuclideanEncoder(in_dim, hidden_dim, out_dim,
                                         dropout=dropout)
        self.hyp_init = ManifoldEncoder(manifold_H, in_dim, hidden_dim,
                                        out_dim)
        self.sph_init = ManifoldEncoder(manifold_S, in_dim, hidden_dim,
                                        out_dim)

    def flax_tree(self):
        return {"euc_init": self.euc_init, "hyp_init": self.hyp_init,
                "sph_init": self.sph_init}

    def forward(self, edge_index, tokens, deterministic=True,
                generator=None):
        e = self.euc_init(tokens, deterministic, generator)
        h = self.hyp_init(tokens, edge_index)
        s = self.sph_init(tokens, edge_index)
        return e, h, s


class StructuralBlock(nn.Module):
    """One RGT layer: a structure learner per manifold, then the H and S
    streams carried to the origin's tangent space and mapped back into
    the Euclidean stream (``proj_0``, ReLU, ``proj_1``, normalised)."""

    def __init__(self, manifold_H, manifold_S, manifold_E, in_dim,
                 hidden_dim, out_dim, dropout=0.1):
        super().__init__()
        self.manifold_H, self.manifold_S = manifold_H, manifold_S
        self.hyp_learner = HyperbolicStructureLearner(
            manifold_H, manifold_S, in_dim, hidden_dim, out_dim, dropout)
        self.sph_learner = SphericalStructureLearner(
            manifold_H, manifold_S, in_dim, hidden_dim, out_dim, dropout)
        self.euc_learner = EuclideanStructureLearner(
            manifold_E, in_dim, hidden_dim, out_dim, dropout)
        self.proj_0 = lecun_dense(3 * out_dim, hidden_dim)
        self.proj_1 = lecun_dense(hidden_dim, out_dim)

    def flax_tree(self):
        return {"hyp_learner": self.hyp_learner,
                "sph_learner": self.sph_learner,
                "euc_learner": self.euc_learner, "proj_0": self.proj_0,
                "proj_1": self.proj_1}

    def forward(self, x_E, x_H, x_S, tree_ei, cycle_ei, seq_ei, num_seeds,
                deterministic=True, generator=None):
        mh, ms = self.manifold_H, self.manifold_S
        x_H = self.hyp_learner(x_H, x_S, tree_ei, num_seeds, deterministic,
                               generator)
        x_S = self.sph_learner(x_H, x_S, cycle_ei, num_seeds, deterministic,
                               generator)
        x_E = self.euc_learner(x_E, seq_ei, num_seeds, deterministic,
                               generator)
        h_e = mh.transp0back(x_H, mh.proju(x_H, x_E))
        s_e = ms.transp0back(x_S, ms.proju(x_S, x_E))
        e = F.relu(lecun_apply(self.proj_0, torch.cat([x_E, h_e, s_e], -1)))
        x_E = lecun_apply(self.proj_1, e)
        x_E = x_E / torch.sqrt((x_E * x_E).sum(-1, keepdim=True) + 1e-8)
        return x_E, x_H, x_S


class RGTModel(nn.Module):
    """The whole RGT. The forward takes the padded batch of
    `ExtractNodeLoader` (tokens, its edges, the tree / cycle / sequence
    buffers, num_seeds) and returns the raw and quantised triples with the
    summed commitment loss; `train_loss` adds the contrastive loss. flax
    names: ``token_proj``, ``init_block``, ``block_{i}``, ``euc_vq``,
    ``hyp_vq``, ``sph_vq``, ``cl_proj`` (``layers_0``, ReLU,
    ``layers_2``). ``in_dim`` may be None: the token map is then lazy."""

    def __init__(self, in_dim, hidden_dim=256, embed_dim=32, n_layers=3,
                 codebook_size=256, codebook_dim=32, codebook_heads=8,
                 dropout=0.1):
        super().__init__()
        self.manifold_H = LorentzM()
        self.manifold_S = SphereM()
        self.manifold_E = EuclideanM()
        mh, ms = self.manifold_H, self.manifold_S
        self.token_proj = lecun_dense(in_dim, embed_dim)
        self.init_block = InitBlock(mh, ms, embed_dim, hidden_dim, embed_dim,
                                    dropout)
        self.blocks = nn.ModuleList(
            StructuralBlock(mh, ms, self.manifold_E, embed_dim, hidden_dim,
                            embed_dim, dropout) for _ in range(n_layers))
        self.euc_vq = VectorQuantizeE(embed_dim, codebook_size, codebook_dim,
                                      codebook_heads)
        self.hyp_vq = VectorQuantizeR(mh, embed_dim, codebook_size,
                                      codebook_dim, codebook_heads)
        self.sph_vq = VectorQuantizeR(ms, embed_dim, codebook_size,
                                      codebook_dim, codebook_heads)
        self.cl_proj = _ProjMLP(2 * embed_dim, hidden_dim, embed_dim)

    def flax_tree(self):
        tree = {"token_proj": self.token_proj, "init_block": self.init_block,
                "euc_vq": self.euc_vq, "hyp_vq": self.hyp_vq,
                "sph_vq": self.sph_vq, "cl_proj": self.cl_proj}
        tree.update({f"block_{i}": b for i, b in enumerate(self.blocks)})
        return tree

    def forward(self, tokens, edge_index, tree_ei, cycle_ei, seq_ei,
                num_seeds, deterministic=True, generator=None):
        tokens = torch.nan_to_num(lecun_apply(self.token_proj, tokens))
        x_E, x_H, x_S = self.init_block(edge_index, tokens, deterministic,
                                        generator)
        for block in self.blocks:
            x_E, x_H, x_S = block(x_E, x_H, x_S, tree_ei, cycle_ei, seq_ei,
                                  num_seeds, deterministic, generator)
        q_E, ind_E, loss_E, _ = self.euc_vq(x_E)
        q_H, ind_H, loss_H, _ = self.hyp_vq(x_H)
        q_S, ind_S, loss_S, _ = self.sph_vq(x_S)
        return dict(x_E=x_E, x_H=x_H, x_S=x_S, q_E=q_E, q_H=q_H, q_S=q_S,
                    indices=(ind_E, ind_H, ind_S),
                    commit_loss=loss_E + loss_H + loss_S)

    def train_loss(self, tokens, edge_index, tree_ei, cycle_ei, seq_ei,
                   num_seeds, deterministic=True, generator=None):
        """The forward and the self-supervised loss: (loss, the fused
        embedding [e || h_e || s_e])."""
        return self.loss(self(tokens, edge_index, tree_ei, cycle_ei, seq_ei,
                              num_seeds, deterministic, generator))

    def loss(self, out):
        """Commitment plus cross-view InfoNCE (reference rgt.py:266-289).
        Returns (loss, fused embedding)."""
        mh, ms = self.manifold_H, self.manifold_S
        q_E, q_H, q_S = out["q_E"], out["q_H"], out["q_S"]
        h_e = mh.transp0back(q_H, mh.proju(q_H, q_E))
        s_e = ms.transp0back(q_S, ms.proju(q_S, q_E))
        e = (h_e + s_e) / 2.0
        h_e = self.cl_proj(torch.cat([mh.logmap0(q_H), h_e], -1))
        s_e = self.cl_proj(torch.cat([ms.logmap0(q_S), s_e], -1))
        loss = (out["commit_loss"] + 0.1 * rgt_cl_loss(h_e, s_e)
                + 0.1 * rgt_cl_loss(h_e, e) + 0.1 * rgt_cl_loss(s_e, e))
        return loss, torch.cat([e, h_e, s_e], -1)


class _ProjMLP(nn.Module):
    """flax's ``nn.Sequential([Dense, relu, Dense])``: ``layers_0``, a
    ReLU, ``layers_2``."""

    def __init__(self, in_dim, hidden_dim, out_dim):
        super().__init__()
        self.layers_0 = lecun_dense(in_dim, hidden_dim)
        self.layers_2 = lecun_dense(hidden_dim, out_dim)

    def flax_tree(self):
        return {"layers_0": self.layers_0, "layers_2": self.layers_2}

    def forward(self, x):
        return lecun_apply(self.layers_2,
                           F.relu(lecun_apply(self.layers_0, x)))


def rgt_cl_loss(x1, x2, tau=0.2, eps=1e-6):
    """Symmetric InfoNCE over cosine similarity (reference
    rgt.py:291-307)."""
    n1 = torch.sqrt((x1 * x1).sum(-1, keepdim=True) + eps)
    n2 = torch.sqrt((x2 * x2).sum(-1, keepdim=True) + eps)
    sim = torch.exp((x1 @ x2.T) / (n1 @ n2.T + eps) / tau)
    pos = torch.diagonal(sim)
    l1 = -torch.log(pos / (sim.sum(0) + eps) + eps).mean()
    l2 = -torch.log(pos / (sim.sum(1) + eps) + eps).mean()
    return (l1 + l2) / 2.0


def rgt_loss(model, batch, deterministic=True, generator=None):
    """The forward and the self-supervised loss of one padded batch (a
    `Graph` of `ExtractNodeLoader`, or a mapping with its keys, as
    tensors on the model's device): (loss, fused embedding)."""
    return model.train_loss(batch["tokens"], batch["edge_index"],
                            batch["tree_edge_index"],
                            batch["cycle_edge_index"],
                            batch["seq_edge_index"], batch["num_seeds"],
                            deterministic, generator)
