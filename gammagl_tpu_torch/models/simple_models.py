"""SGC, GIN, APPNP, GCNII, JKNet, MLP, ChebNet, MixHop, GPR-GNN and FAGCN
models (counterparts of `gammagl_tpu/models/simple_models.py`).

Every model but `MLP` and `GINModel` takes ``plan`` (a `CSRPlan`) and
hands it to each of its convs, so on the card every hop is a launch of the
CSR SpMM kernel; `GINModel` passes none, as the JAX model does. Dropout
(flax's ``nn.Dropout``: keep 1 - rate, scale the kept) is active in
training mode only and draws from ``generator``, so one generator state
gives the plan and COO paths the same masks. Each model names its flax
counterpart's parameters in ``flax_tree`` (`utils.load_jax_params`);
``in_channels=None`` leaves the first map lazy, as flax infers it.
"""

import math

import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.conv.simple_convs import (
    APPNPConv, ChebConv, FAGCNConv, GCNIIConv, GINConv, GPRConv,
    JumpingKnowledge, MixHopConv, SGConv)
from gammagl_tpu_torch.layers.dense import dropout, lecun_apply, lecun_dense
from gammagl_tpu_torch.layers.pool import global_sum_pool

__all__ = ["SGCModel", "GINModel", "APPNPModel", "GCNIIModel", "JKNet",
           "MLP", "ChebNetModel", "MixHopModel", "GPRGNNModel", "FAGCNModel"]


class _Model(nn.Module):
    """A model whose dropout rate is ``drop_rate`` in training mode."""

    def _drop(self, x, generator):
        return dropout(x, self.drop_rate if self.training else 0.0,
                       generator)


class MLP(_Model):
    """The plain MLP baseline: a ReLU layer for each width of
    ``hidden_dim``, dropout after each, then a map to ``num_class``
    (flax ``Dense_0`` ... in that order)."""

    def __init__(self, hidden_dim=(64,), num_class=7, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        dims = [in_channels, *hidden_dim, num_class]
        self.lins = nn.ModuleList(lecun_dense(a, b)
                                  for a, b in zip(dims, dims[1:]))

    def flax_tree(self):
        return {f"Dense_{i}": lin for i, lin in enumerate(self.lins)}

    def forward(self, x, generator=None):
        for lin in self.lins[:-1]:
            x = self._drop(F.relu(lecun_apply(lin, x)), generator)
        return lecun_apply(self.lins[-1], x)


class SGCModel(nn.Module):
    """One `SGConv` of ``itera_k`` hops to ``num_class`` (``SGConv_0``)."""

    def __init__(self, num_class=7, itera_k=2, in_channels=None):
        super().__init__()
        self.conv = SGConv(in_channels, num_class, itera_k=itera_k)

    def flax_tree(self):
        return {"SGConv_0": self.conv}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        return self.conv(x, edge_index, edge_weight, num_nodes, plan=plan)


class _Dense(nn.Module):
    """flax's default ``Dense`` as a module of an ``nn.Sequential``."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.lin = lecun_dense(in_channels, out_channels)

    def forward(self, x):
        return lecun_apply(self.lin, x)


class GINModel(_Model):
    """GIN for graph classification (Xu et al. 2019): ``num_layers``
    GINConvs, each with a two-layer ReLU MLP and a LayerNorm (flax's
    epsilon, 1e-6), each layer's output sum-pooled by ``batch`` and
    scored by its own map to ``num_class`` (dropout on the scores), the
    scores summed. ``batch=None`` pools the whole graph into one row, so
    the logits are (1, num_class) (the gin twin's node task: ROADMAP C18).
    The convs take no plan, as in the JAX model.

    flax names: layer i's MLP ``Dense_{3i}`` and ``Dense_{3i+1}``, its
    score ``Dense_{3i+2}``, its norm ``LayerNorm_{i}``.
    """

    def __init__(self, hidden_dim=64, num_class=2, num_layers=5,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList()
        self.norms = nn.ModuleList()
        self.scores = nn.ModuleList()
        for i in range(num_layers):
            mlp = nn.Sequential(
                _Dense(in_channels if i == 0 else hidden_dim, hidden_dim),
                nn.ReLU(), _Dense(hidden_dim, hidden_dim), nn.ReLU())
            self.convs.append(GINConv(apply_func=mlp))
            self.norms.append(nn.LayerNorm(hidden_dim, eps=1e-6))
            self.scores.append(lecun_dense(hidden_dim, num_class))

    def flax_tree(self):
        tree = {}
        for i, (conv, norm, score) in enumerate(zip(self.convs, self.norms,
                                                    self.scores)):
            tree[f"Dense_{3 * i}"] = conv.apply_func[0].lin
            tree[f"Dense_{3 * i + 1}"] = conv.apply_func[2].lin
            tree[f"Dense_{3 * i + 2}"] = score
            tree[f"LayerNorm_{i}"] = norm
        return tree

    def forward(self, x, edge_index, batch=None, num_graphs=None,
                num_nodes=None, generator=None):
        out = 0
        for conv, norm, score in zip(self.convs, self.norms, self.scores):
            x = norm(conv(x, edge_index, num_nodes=num_nodes))
            pooled = global_sum_pool(x, batch, num_graphs)
            out = out + self._drop(lecun_apply(score, pooled), generator)
        return out


class APPNPModel(_Model):
    """APPNP (Klicpera et al. 2019): dropout, a ReLU map to ``hidden_dim``
    (``Dense_0``), dropout, a map to ``num_class`` (``Dense_1``), then
    ``itera_k`` personalised-PageRank hops at ``alpha``."""

    def __init__(self, hidden_dim=64, num_class=7, alpha=0.1, itera_k=10,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.lin1 = lecun_dense(hidden_dim, num_class)
        self.prop = APPNPConv(itera_k=itera_k, alpha=alpha)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        x = self._drop(x, generator)
        x = self._drop(F.relu(lecun_apply(self.lin0, x)), generator)
        x = lecun_apply(self.lin1, x)
        return self.prop(x, edge_index, edge_weight, num_nodes, plan=plan,
                         generator=generator)


class GCNIIModel(_Model):
    """GCNII (Chen et al. 2020): dropout, a ReLU map to ``hidden_dim``
    (``Dense_0``, giving x0), then ``num_layers`` GCNIIConvs (layer l at
    beta = log(lambd / l + 1)), each after dropout and followed by a ReLU,
    then dropout and a map to ``num_class`` (``Dense_1``)."""

    def __init__(self, hidden_dim=64, num_class=7, num_layers=64, alpha=0.1,
                 lambd=0.5, variant=False, drop_rate=0.6, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.convs = nn.ModuleList(
            GCNIIConv(hidden_dim, hidden_dim,
                      beta=math.log(lambd / layer + 1), alpha=alpha,
                      variant=variant)
            for layer in range(1, num_layers + 1))
        self.lin1 = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {f"GCNIIConv_{i}": conv for i, conv in enumerate(self.convs)}
        tree.update({"Dense_0": self.lin0, "Dense_1": self.lin1})
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        x = self._drop(x, generator)
        x = x0 = F.relu(lecun_apply(self.lin0, x))
        for conv in self.convs:
            x = self._drop(x, generator)
            x = F.relu(conv(x, x0, edge_index, edge_weight, num_nodes,
                            plan=plan))
        return lecun_apply(self.lin1, self._drop(x, generator))


class JKNet(_Model):
    """GCN with jumping knowledge (Xu et al. 2018): ``num_layers`` ReLU
    GCNConvs of ``hidden_dim`` (``GCNConv_{i}``), dropout after each, the
    layers' outputs combined by `JumpingKnowledge` in ``mode``
    (``JumpingKnowledge_0``, parameters in 'att' mode only), then a map
    to ``num_class`` (``Dense_0``)."""

    def __init__(self, hidden_dim=16, num_class=7, num_layers=4, mode="max",
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList(
            GCNConv(in_channels if i == 0 else hidden_dim, hidden_dim)
            for i in range(num_layers))
        self.jk = JumpingKnowledge(mode=mode, channels=hidden_dim)
        width = hidden_dim * (num_layers if mode == "cat" else 1)
        self.lin = lecun_dense(width, num_class)

    def flax_tree(self):
        tree = {f"GCNConv_{i}": conv for i, conv in enumerate(self.convs)}
        if self.jk.flax_tree():
            tree["JumpingKnowledge_0"] = self.jk
        tree["Dense_0"] = self.lin
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        xs = []
        for conv in self.convs:
            x = F.relu(conv(x, edge_index, edge_weight, num_nodes,
                            plan=plan))
            x = self._drop(x, generator)
            xs.append(x)
        return lecun_apply(self.lin, self.jk(xs))


class ChebNetModel(_Model):
    """Two ChebConvs of ``K`` terms (``ChebConv_0`` to ``hidden_dim``,
    ReLU, dropout; ``ChebConv_1`` to ``num_class``)."""

    def __init__(self, hidden_dim=32, num_class=7, K=3, drop_rate=0.5,
                 in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.convs = nn.ModuleList([ChebConv(in_channels, hidden_dim, K=K),
                                    ChebConv(hidden_dim, num_class, K=K)])

    def flax_tree(self):
        return {f"ChebConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        x = F.relu(self.convs[0](x, edge_index, edge_weight, num_nodes,
                                 plan=plan))
        x = self._drop(x, generator)
        return self.convs[1](x, edge_index, edge_weight, num_nodes,
                             plan=plan)


class MixHopModel(_Model):
    """``num_layers - 1`` MixHopConvs (``MixHopConv_{i}``: hidden_dim //
    len(p) columns a power, ReLU, dropout), then a map to ``num_class``
    (``Dense_0``)."""

    def __init__(self, hidden_dim=60, num_class=7, p=(0, 1, 2), num_layers=2,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        per = hidden_dim // len(p)
        self.convs = nn.ModuleList(
            MixHopConv(in_channels if i == 0 else per * len(p), per, p=p)
            for i in range(num_layers - 1))
        self.lin = lecun_dense(per * len(p) if self.convs else in_channels,
                          num_class)

    def flax_tree(self):
        tree = {f"MixHopConv_{i}": conv for i, conv in enumerate(self.convs)}
        tree["Dense_0"] = self.lin
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        for conv in self.convs:
            x = F.relu(conv(x, edge_index, edge_weight, num_nodes,
                            plan=plan))
            x = self._drop(x, generator)
        return lecun_apply(self.lin, x)


class GPRGNNModel(_Model):
    """GPR-GNN (Chien et al. 2021): dropout, a ReLU map to ``hidden_dim``
    (``Dense_0``), dropout, a map to ``num_class`` (``Dense_1``), then a
    `GPRConv` of ``K`` hops (``GPRConv_0``) from PageRank's weights."""

    def __init__(self, hidden_dim=64, num_class=7, K=10, alpha=0.1,
                 drop_rate=0.5, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.lin1 = lecun_dense(hidden_dim, num_class)
        self.prop = GPRConv(K=K, alpha=alpha)

    def flax_tree(self):
        return {"Dense_0": self.lin0, "Dense_1": self.lin1,
                "GPRConv_0": self.prop}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None, generator=None):
        x = self._drop(x, generator)
        x = self._drop(F.relu(lecun_apply(self.lin0, x)), generator)
        return self.prop(lecun_apply(self.lin1, x), edge_index, edge_weight,
                         num_nodes, plan=plan)


class FAGCNModel(_Model):
    """FAGCN (Bo et al. 2021): dropout, a ReLU map to ``hidden_dim``
    (``Dense_0``, giving h0), dropout, ``num_layers`` steps of x <- 0.3 h0
    + FAGCNConv(x) (``FAGCNConv_{i}``), then a map to ``num_class``
    (``Dense_1``)."""

    eps = 0.3

    def __init__(self, hidden_dim=16, num_class=7, num_layers=2,
                 drop_rate=0.4, in_channels=None):
        super().__init__()
        self.drop_rate = drop_rate
        self.lin0 = lecun_dense(in_channels, hidden_dim)
        self.convs = nn.ModuleList(FAGCNConv(hidden_dim)
                                   for _ in range(num_layers))
        self.lin1 = lecun_dense(hidden_dim, num_class)

    def flax_tree(self):
        tree = {f"FAGCNConv_{i}": conv for i, conv in enumerate(self.convs)}
        tree.update({"Dense_0": self.lin0, "Dense_1": self.lin1})
        return tree

    def forward(self, x, edge_index, num_nodes=None, plan=None,
                generator=None):
        x = self._drop(x, generator)
        x = self._drop(F.relu(lecun_apply(self.lin0, x)), generator)
        h0 = x
        for conv in self.convs:
            x = self.eps * h0 + conv(x, edge_index, num_nodes, plan=plan,
                                     generator=generator)
        return lecun_apply(self.lin1, x)
