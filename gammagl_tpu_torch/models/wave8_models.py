"""GEN (EM estimation of the adjacency) and FatraGNN (fairness under
distribution shift), counterparts of `gammagl_tpu/models/wave8_models.py`
(reference: gammagl/models/gen.py GEstimationN:8-156 and
gammagl/models/fatragnn.py FatraGNNModel:45-103, Graph_Editer:105-189).

`GEstimationN` and `modify_structure` are host numpy, as in the JAX
package (dense (N, N) observation matrices; data-dependent edge counts).
FatraGNN's encoder is a GCNConv with no plan: its sums are the port's COO
ops on every device.
"""

from collections import Counter

import numpy as np
import torch
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.models.wave7_models import _unit_rows
from gammagl_tpu_torch.utils.misc import homophily

__all__ = ["GEstimationN", "FatraGNNModel", "GraphEditer",
           "modify_structure"]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class GEstimationN:
    """EM estimation of the adjacency (reference gen.py:8-156): the
    observed graph and further graphs (k-NN graphs, say) are noisy
    measurements ``E`` of a latent block-model network; `em` estimates
    each pair's edge probability Q. Host numpy over dense (N, N) arrays,
    as in the JAX package; the graph's node homophily (`homophily`)
    decides whether the observed edges are added to Q."""

    def __init__(self, num_nodes, num_classes, edge_index, y, train_idx):
        self.num_node = int(num_nodes)
        self.num_class = int(num_classes)
        self.idx_train = _np(train_idx)
        self.label = _np(y)
        ei = _np(edge_index)
        self.adj = np.zeros((self.num_node, self.num_node))
        self.adj[ei[0], ei[1]] = 1.0
        self.output = None
        self.iterations = 0
        self.homophily = float(homophily(ei, self.label, method="node"))

    def reset_obs(self):
        self.N = 0
        self.E = np.zeros((self.num_node, self.num_node), np.int64)

    def update_obs(self, output):
        """Add one observed adjacency (dense 0/1)."""
        self.E += _np(output).astype(np.int64)
        self.N += 1

    def revise_pred(self):
        self.output[self.idx_train] = self.label[self.idx_train]

    def e_step(self, Q):
        an = np.triu(Q * self.E, 1).sum()
        bn = np.triu((1 - Q) * self.E, 1).sum()
        ad = np.triu(Q * self.N + np.zeros_like(Q), 1).sum()
        bd = np.triu((1 - Q) * self.N, 1).sum()
        alpha = an / ad
        beta = bn / bd

        O = np.zeros((self.num_class, self.num_class))
        counter = Counter(self.output.tolist())
        n = [counter[i] for i in range(self.num_class)]
        a = np.repeat(self.output, self.num_node).reshape(self.num_node, -1)
        for j in range(self.num_class):
            c = a == j
            for i in range(j + 1):
                b = a == i
                O[i, j] = np.triu((b & c.T) * Q, 1).sum()
                if i == j:
                    O[j, j] *= 2.0 / max(n[j] * (n[j] - 1), 1)
                else:
                    O[i, j] *= 1.0 / max(n[i] * n[j], 1)
        return alpha, beta, O

    def m_step(self, alpha, beta, O):
        O = O + O.T - np.diag(O.diagonal())
        row = np.repeat(self.output, self.num_node)
        col = np.tile(self.output, self.num_node)
        tmp = O[row, col].reshape(self.num_node, -1)
        p1 = tmp * np.power(alpha, self.E) * np.power(
            1 - alpha, self.N - self.E)
        p2 = (1 - tmp) * np.power(beta, self.E) * np.power(
            1 - beta, self.N - self.E)
        return p1 / np.maximum(p1 + p2, 1e-12)

    def em(self, output, tolerance=1e-6, seed=0, max_iters=100):
        """The EM loop (reference gen.py:117-156) from the predicted
        labels ``output`` (the training labels put back); its start drawn
        from ``np.random.default_rng(seed)``. Returns (alpha, beta, O, Q,
        iterations)."""
        rng = np.random.default_rng(seed)
        self.output = np.array(_np(output))
        self.revise_pred()
        beta, alpha = np.sort(rng.random(2))
        O = np.triu(rng.random((self.num_class, self.num_class)))
        Q = self.m_step(alpha, beta, O)
        alpha_p = beta_p = 0.0
        while (abs(alpha_p - alpha) > tolerance
               or abs(beta_p - beta) > tolerance):
            alpha_p, beta_p = alpha, beta
            alpha, beta, O = self.e_step(Q)
            Q = self.m_step(alpha, beta, O)
            self.iterations += 1
            if self.iterations >= max_iters:
                break
        if self.homophily > 0.5:
            Q = Q + self.adj
        return alpha, beta, O, Q, self.iterations

    # the reference's method names (gen.py)
    E_step = e_step
    M_step = m_step
    EM = em


class GraphEditer(nn.Module):
    """FatraGNN's feature editor (reference fatragnn.py:105-112,
    forward:185-189): x + 0.1 * ``transFeature``(x)."""

    def __init__(self, num_features):
        super().__init__()
        self.transFeature = lecun_dense(num_features, num_features)

    def flax_tree(self):
        return {"transFeature": self.transFeature}

    def forward(self, x):
        return x + 0.1 * lecun_apply(self.transFeature, x)


def modify_structure(edge_index, a2_edge, sens, drop=0.8, seed=13,
                     align=True):
    """Fairness-aware structure edit (reference fatragnn.py:113-183), host
    numpy: drop a share ``drop`` of the edges whose ends differ in ``sens``
    and add as many candidate edges of ``a2_edge`` (ends of one ``sens``
    when ``align``, else of two; no self-loops), both drawn from
    ``np.random.default_rng(seed)``. Returns the added edges, then the
    kept ones, as the JAX function does."""
    rng = np.random.default_rng(seed)
    ei = _np(edge_index)
    a2 = _np(a2_edge)
    sens = _np(sens)

    mismatch = sens[ei[0]] != sens[ei[1]]
    yipei = np.nonzero(mismatch)[0]
    n_drop = int(len(yipei) * drop)
    drop_ids = rng.choice(yipei, n_drop, replace=False) \
        if n_drop else np.zeros(0, np.int64)
    keep = np.ones(ei.shape[1], bool)
    keep[drop_ids] = False
    kept = ei[:, keep]

    same = (sens[a2[0]] == sens[a2[1]]) if align \
        else (sens[a2[0]] != sens[a2[1]])
    cand = np.nonzero(same & (a2[0] != a2[1]))[0]
    n_add = min(n_drop, len(cand))
    add_ids = rng.choice(cand, n_add, replace=False) \
        if n_add else np.zeros(0, np.int64)
    return np.concatenate([a2[:, add_ids], kept], axis=1)


class FatraGNNModel(nn.Module):
    """FatraGNN (reference fatragnn.py:45-103): a GCNConv encoder over
    unit edge weights (``encoder``), a classifier and a discriminator (one
    logit each) and the feature editor (``graphEdit``), chosen by
    ``flag`` as in the reference forward: 0 the classifier's logits, 1 and
    3 the discriminator's probability, 2 the classifier's, 4 the
    classifier on the edited features over ``edge_index2`` (unit rows),
    5 {"h1", "h2"}: the unit-row encodings of the graph and of the edited
    one."""

    def __init__(self, num_features, hidden=16):
        super().__init__()
        self.encoder = GCNConv(num_features, hidden)
        self.classifier = lecun_dense(hidden, 1)
        self.discriminator = lecun_dense(hidden, 1)
        self.graph_edit = GraphEditer(num_features)

    def flax_tree(self):
        return {"encoder": self.encoder, "classifier": self.classifier,
                "discriminator": self.discriminator,
                "graphEdit": self.graph_edit}

    def _enc(self, x, edge_index):
        w = torch.ones(edge_index.shape[1], dtype=x.dtype, device=x.device)
        return self.encoder(x, edge_index, w, x.shape[0])

    def forward(self, x, edge_index, flag=0, edge_index2=None):
        if flag == 0:
            return lecun_apply(self.classifier, self._enc(x, edge_index))
        if flag in (1, 3):
            return torch.sigmoid(lecun_apply(self.discriminator,
                                             self._enc(x, edge_index)))
        if flag == 2:
            return torch.sigmoid(lecun_apply(self.classifier,
                                             self._enc(x, edge_index)))
        if flag == 4:
            h2 = _unit_rows(self._enc(self.graph_edit(x), edge_index2))
            return lecun_apply(self.classifier, h2)
        if flag == 5:
            h2 = _unit_rows(self._enc(self.graph_edit(x), edge_index2))
            h1 = _unit_rows(self._enc(x, edge_index))
            return {"h1": h1, "h2": h2}
        raise ValueError(f"unknown flag {flag}")
