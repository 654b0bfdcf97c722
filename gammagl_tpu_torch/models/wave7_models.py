"""DHN, HEAT, CoED, NodeID (residual vector quantisation), GNRF (a graph
neural ODE), GRACE-POT and GRACE-Spco (counterparts of
`gammagl_tpu/models/wave7_models.py`; reference: gammagl/models/
{dhn,heat,coed,nodeid,gnrf,grace_pot,grace_spco}.py).

They take no plan, as in the JAX package: their sums are the port's COO
ops on every device. Each model names its flax counterpart's parameters
in ``flax_tree`` (`utils.load_jax_params`); ``in_channels=None`` leaves
the first maps lazy, as flax infers them. NodeID's codebooks and their
running statistics are buffers, JAX's ``vq_stats`` collection
(``flax_state``). GNRF integrates with fixed-step RK4, differentiated
through the solver, as the JAX model does. Dropout is active in training
mode only and draws from a ``generator`` (None: the default generator of
the tensor's device).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GATConv, GCNConv, JumpingKnowledge
from gammagl_tpu_torch.layers.conv.wave2_convs import _take
from gammagl_tpu_torch.layers.conv.wave7_convs import (CoEDConv, DHNConv,
                                                       HEATConv, _glorot)
from gammagl_tpu_torch.layers.dense import (dropout, glorot_dense,
                                            lecun_apply, lecun_dense)
from gammagl_tpu_torch.models.ssl import grace_loss
from gammagl_tpu_torch.ops.segment import segment_mean, segment_sum

__all__ = ["DHNModel", "HEATModel", "CoEDModel", "VectorQuantize",
           "ResidualVectorQuant", "NodeIDModel", "odeint_rk4", "GNRFModel",
           "GracePOTModel", "grace_pot_bounds", "GraceSpcoModel"]


def _unit_rows(z):
    """Rows scaled to unit length (+1e-12)."""
    return z / (torch.linalg.vector_norm(z, dim=1, keepdim=True) + 1e-12)


class DHNModel(nn.Module):
    """DHN link prediction (reference dhn.py:5-28): a DHNConv tower for
    each endpoint's neighbourhood block (``dhn1``, ``dhn2``), joined, then
    ``lin1`` (ELU) and ``lin2`` (ELU) to one score; glorot-uniform
    kernels."""

    def __init__(self, num_fea, num_neighbor, hidden=64):
        super().__init__()
        self.dhn1 = DHNConv(num_fea, num_neighbor, hidden)
        self.dhn2 = DHNConv(num_fea, num_neighbor, hidden)
        self.lin1 = glorot_dense(2 * hidden, hidden)
        self.lin2 = glorot_dense(hidden, 1)

    def flax_tree(self):
        return {"dhn1": self.dhn1, "dhn2": self.dhn2, "lin1": self.lin1,
                "lin2": self.lin2}

    def forward(self, n1, n2):
        h = torch.cat([self.dhn1(n1), self.dhn2(n2)], dim=1)
        return F.elu(_glorot(self.lin2, F.elu(_glorot(self.lin1, h))))


class HEATModel(nn.Module):
    """HEAT trajectory prediction (reference heat.py:5-98): each agent's
    flattened history through ``lin1`` (glorot), two HEATConvs
    (``heat_conv1``, ``heat_conv2``) with dropout after each, ``fc``
    (leaky ReLU) and ``lin2`` to ``out_length`` future (x, y) offsets.
    The history, edge attribute and edge type widths are lazy when
    None."""

    def __init__(self, in_channels_node=64, out_channels=128, out_length=12,
                 node_emb_size=64, edge_attr_emb_size=64,
                 edge_type_emb_size=64, heads=3, concat=True,
                 dropout_rate=0.1, leaky_rate=0.2, in_channels=None,
                 edge_attr_channels=None, edge_type_channels=None):
        super().__init__()
        self.dropout_rate, self.leaky_rate = dropout_rate, leaky_rate
        width = heads * out_channels if concat else out_channels
        kw = dict(edge_attr_channels=edge_attr_channels,
                  edge_type_channels=edge_type_channels,
                  node_emb_size=node_emb_size,
                  edge_attr_emb_size=edge_attr_emb_size,
                  edge_type_emb_size=edge_type_emb_size,
                  out_channels=out_channels, heads=heads, concat=concat)
        self.lin1 = glorot_dense(in_channels, in_channels_node)
        self.heat_conv1 = HEATConv(in_channels_node, **kw)
        self.heat_conv2 = HEATConv(width, **kw)
        self.fc = lecun_dense(width, out_channels)
        self.lin2 = lecun_dense(out_channels, out_length * 2)

    def flax_tree(self):
        return {"lin1": self.lin1, "heat_conv1": self.heat_conv1,
                "heat_conv2": self.heat_conv2, "fc": self.fc,
                "lin2": self.lin2}

    def forward(self, x, edge_index, edge_attr, edge_type, generator=None):
        rate = self.dropout_rate if self.training else 0.0
        h = _glorot(self.lin1, x.reshape(x.shape[0], -1))
        h = dropout(self.heat_conv1(h, edge_index, edge_attr, edge_type),
                    rate, generator)
        h = dropout(self.heat_conv2(h, edge_index, edge_attr, edge_type),
                    rate, generator)
        h = F.leaky_relu(lecun_apply(self.fc, h), self.leaky_rate)
        return lecun_apply(self.lin2, h)


class CoEDModel(nn.Module):
    """CoED-GNN node classification (reference coed.py:14-132):
    ``num_layers`` CoEDConvs (``conv1``...) combined as alpha * forward +
    (1 - alpha) * reverse (+ self); ReLU, dropout and, with ``normalize``,
    unit rows after each layer but the last (after every layer with jumping
    knowledge, which then joins them), and ``readout`` (glorot) to the
    classes."""

    def __init__(self, num_class, hidden_dim=64, num_layers=2, alpha=0.0,
                 drop_rate=0.5, normalize=False, self_feature_transform=False,
                 jumping_knowledge="", in_channels=None):
        super().__init__()
        self.alpha, self.drop_rate = alpha, drop_rate
        self.normalize = normalize
        self.convs = nn.ModuleList(
            CoEDConv(in_channels if i == 0 else hidden_dim, hidden_dim,
                     self_feature_transform=self_feature_transform)
            for i in range(num_layers))
        self.jk = (JumpingKnowledge(jumping_knowledge, hidden_dim)
                   if jumping_knowledge else None)
        width = (num_layers * hidden_dim if jumping_knowledge == "cat"
                 else hidden_dim)
        self.readout = glorot_dense(width, num_class)

    def flax_tree(self):
        tree = {f"conv{i + 1}": c for i, c in enumerate(self.convs)}
        if self.jk is not None:
            tree["JumpingKnowledge_0"] = self.jk
        tree["readout"] = self.readout
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                generator=None):
        rate = self.drop_rate if self.training else 0.0
        xs, last = [], len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            out = conv(x, edge_index, edge_weight, num_nodes)
            x = self.alpha * out[0] + (1 - self.alpha) * out[1]
            if len(out) == 3:
                x = x + out[2]
            if i != last or self.jk is not None:
                x = dropout(F.relu(x), rate, generator)
                if self.normalize:
                    x = _unit_rows(x)
                xs.append(x)
        if self.jk is not None:
            x = self.jk(xs)
        return _glorot(self.readout, x)


class VectorQuantize(nn.Module):
    """EMA vector quantiser (reference nodeid.py:16-101), the JAX
    module's function.

    State, JAX's ``vq_stats`` collection, as buffers: the codebook
    ``embed`` (glorot-uniform, drawn from ``generator``, or the default
    generator, at construction; JAX draws it from ``PRNGKey(0)`` and
    `load_jax_params` carries it across), its running sums ``embed_avg``
    and the running counts ``cluster_size`` (0 at init). Each row takes
    the code of largest cosine similarity (the first on a tie). In
    training mode the forward then updates the state in place (decay
    ``decay``; Laplace-smoothed counts) and, as in the JAX module, replaces
    each dead code (running count below ``threshold_ema_dead_code``) by an
    input row chosen round-robin, code c by row c mod N, with its count
    set to the threshold; this draws nothing. The quantised rows are
    straight-through in training mode. Returns (quantised, code ids,
    commitment loss times ``commitment_weight``)."""

    def __init__(self, dim, codebook_size, commitment_weight=0.25, decay=0.8,
                 eps=1e-5, threshold_ema_dead_code=2.0, generator=None):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.commitment_weight, self.decay = commitment_weight, decay
        self.eps = eps
        self.threshold_ema_dead_code = threshold_ema_dead_code
        embed = torch.empty(codebook_size, dim)
        lim = (6.0 / (codebook_size + dim)) ** 0.5
        embed.uniform_(-lim, lim, generator=generator)
        self.register_buffer("embed", embed)
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("cluster_size", torch.zeros(codebook_size))

    def flax_tree(self):
        return {}

    def flax_state(self):
        return {"vq_stats": {"embed": self.embed, "embed_avg": self.embed_avg,
                             "cluster_size": self.cluster_size}}

    @torch.no_grad()
    def _update(self, flat, onehot):
        counts = onehot.sum(0)
        embed_sum = onehot.T @ flat
        new_cs = self.cluster_size * self.decay + (1 - self.decay) * counts
        new_avg = self.embed_avg * self.decay + (1 - self.decay) * embed_sum
        total = new_cs.sum()
        smoothed = torch.where(
            total > 0,
            (new_cs + self.eps) / (total + self.codebook_size * self.eps)
            * total, torch.ones_like(new_cs))
        new_embed = new_avg / smoothed.clamp_min(self.eps)[:, None]
        dead = new_cs < self.threshold_ema_dead_code
        refresh = flat[torch.arange(self.codebook_size, device=flat.device)
                       % flat.shape[0]]
        new_embed = torch.where(dead[:, None], refresh, new_embed)
        new_avg = torch.where(dead[:, None], new_embed, new_avg)
        new_cs = torch.where(dead, torch.full_like(
            new_cs, self.threshold_ema_dead_code), new_cs)
        self.embed.copy_(new_embed)
        self.embed_avg.copy_(new_avg)
        self.cluster_size.copy_(new_cs)

    def forward(self, x):
        flat = x.reshape(-1, self.dim)
        embed = self.embed.to(flat.dtype)
        sim = _unit_rows(flat) @ _unit_rows(embed).T
        ind = sim.argmax(-1)
        onehot = F.one_hot(ind, self.codebook_size).to(flat.dtype)
        quantize = onehot @ embed
        if self.training:
            self._update(flat.detach(), onehot)
        quantize = quantize.reshape(x.shape)
        if self.training:
            quantize = x + (quantize - x).detach()
        commit = ((quantize.detach() - x) ** 2).mean()
        return (quantize, ind.reshape(x.shape[:-1]),
                commit * self.commitment_weight)


class ResidualVectorQuant(nn.Module):
    """``num_res_layers`` VectorQuantizes (``vq{i}``), each on what the
    ones before left (reference nodeid.py:104-147). Returns (the sum of
    the quantised rows, the list of code ids, the summed commitment
    loss)."""

    def __init__(self, dim, codebook_size, num_res_layers=3,
                 commitment_weight=0.25, decay=0.8, generator=None):
        super().__init__()
        self.vqs = nn.ModuleList(
            VectorQuantize(dim, codebook_size,
                           commitment_weight=commitment_weight, decay=decay,
                           generator=generator)
            for _ in range(num_res_layers))

    def flax_tree(self):
        return {f"vq{i}": vq for i, vq in enumerate(self.vqs)}

    def forward(self, x):
        total, out, inds, residual = 0.0, 0.0, [], x
        for vq in self.vqs:
            q, ind, loss = vq(residual)
            total = total + loss
            inds.append(ind)
            out = out + q
            residual = residual - q
        return out, inds, total


class NodeIDModel(nn.Module):
    """NodeID (reference nodeid.py:150-256): ``lin_in`` and dropout, then
    ``local_layers`` layers, each an optional LayerNorm (``pre_ln{i}``), a
    GATConv without bias (attention dropout ``dropout``) or a GCNConv
    (``conv{i}``) plus a map of its input (``lin{i}``), ReLU and dropout,
    summed over the layers and residual-quantised (``rvq{i}``, three
    codebooks of ``num_codes``). Returns (``pred_local`` logits of the
    sum, the commitment loss, the (N, 3 * local_layers) code ids,
    ``linear_gnn`` of the sum)."""

    def __init__(self, in_channels, hidden_channels, out_channels,
                 local_layers=3, dropout=0.5, heads=1, pre_ln=False,
                 num_codes=16, gnn="gat", generator=None):
        super().__init__()
        hidden = hidden_channels * heads
        self.dropout = dropout
        self.lin_in = lecun_dense(in_channels, hidden)
        self.pre_lns = nn.ModuleList(
            nn.LayerNorm(hidden, eps=1e-6) for _ in range(local_layers)
        ) if pre_ln else None
        self.convs = nn.ModuleList(
            GATConv(hidden, hidden_channels, heads=heads,
                    dropout_rate=dropout, add_bias=False) if gnn == "gat"
            else GCNConv(hidden, hidden) for _ in range(local_layers))
        self.lins = nn.ModuleList(lecun_dense(hidden, hidden)
                                  for _ in range(local_layers))
        self.rvqs = nn.ModuleList(ResidualVectorQuant(hidden, num_codes,
                                                      generator=generator)
                                  for _ in range(local_layers))
        self.linear_gnn = lecun_dense(hidden, local_layers * 3)
        self.pred_local = lecun_dense(hidden, out_channels)

    def flax_tree(self):
        tree = {"lin_in": self.lin_in, "linear_gnn": self.linear_gnn,
                "pred_local": self.pred_local}
        for i in range(len(self.convs)):
            tree.update({f"conv{i}": self.convs[i], f"lin{i}": self.lins[i],
                         f"rvq{i}": self.rvqs[i]})
            if self.pre_lns is not None:
                tree[f"pre_ln{i}"] = self.pre_lns[i]
        return tree

    def forward(self, x, edge_index, num_nodes=None, generator=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        rate = self.dropout if self.training else 0.0
        x = dropout(lecun_apply(self.lin_in, x), rate, generator)
        ids, commit, x_local = [], 0.0, 0.0
        for i, conv in enumerate(self.convs):
            if self.pre_lns is not None:
                x = self.pre_lns[i](x)
            if isinstance(conv, GATConv):
                h = conv(x, edge_index, num_nodes=num_nodes,
                         generator=generator)
            else:
                h = conv(x, edge_index, num_nodes=num_nodes)
            x = h + lecun_apply(self.lins[i], x)
            x = dropout(F.relu(x), rate, generator)
            x_local = x_local + x
            _, code_inds, loss = self.rvqs[i](x)
            ids.append(torch.stack(code_inds, dim=1))
            commit = commit + loss
        return (lecun_apply(self.pred_local, x_local), commit,
                torch.cat(ids, dim=1), lecun_apply(self.linear_gnn, x_local))


def odeint_rk4(func, y0, t0, t1, num_steps=8):
    """``y(t1)`` of dy/dt = func(t, y), y(t0) = y0, by ``num_steps``
    fixed steps of classic RK4; differentiable through the steps."""
    dt = (t1 - t0) / num_steps
    y = y0
    for i in range(num_steps):
        t = t0 + i * dt
        k1 = func(t, y)
        k2 = func(t + dt / 2, y + dt * k1 / 2)
        k3 = func(t + dt / 2, y + dt * k2 / 2)
        k4 = func(t + dt, y + dt * k3)
        y = y + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6
    return y


class _MLP(nn.Module):
    """flax's ``Sequential([Dense(hidden), relu, Dense(out)])``."""

    def __init__(self, in_channels, hidden, out):
        super().__init__()
        self.lin0 = lecun_dense(in_channels, hidden)
        self.lin1 = lecun_dense(hidden, out)

    def forward(self, x):
        return lecun_apply(self.lin1, F.relu(lecun_apply(self.lin0, x)))


class _GNRFFunc(nn.Module):
    """dH/dt of the neural repulsion field (reference gnrf.py:219-288):
    each edge's curvature scales the neighbour difference H[dst] - H[src]
    (tangential, on the unit sphere, with ``damping``), averaged into the
    source. With ``edgenet`` the curvature is learned: ``mlp_1`` (ReLU) of
    [H[src], H[dst]] summed into the source, ``mlp_2`` of the two ends'
    sums, through a sigmoid into (0, 1) (flax names ``Dense_0``/``1`` and
    ``Dense_2``/``3``); else one scalar ``a`` (0.5 at init) clipped to
    [1e-8, 1]."""

    def __init__(self, hidden, edgenet=True, channel_curv=False,
                 damping=False):
        super().__init__()
        self.edgenet, self.damping = edgenet, damping
        if edgenet:
            self.mlp_1 = _MLP(2 * hidden, hidden, hidden)
            self.mlp_2 = _MLP(2 * hidden, hidden,
                              hidden if channel_curv else 1)
        else:
            self.a = nn.Parameter(torch.tensor(0.5))

    def flax_tree(self):
        if not self.edgenet:
            return {"a": self.a}
        return {"Dense_0": self.mlp_1.lin0, "Dense_1": self.mlp_1.lin1,
                "Dense_2": self.mlp_2.lin0, "Dense_3": self.mlp_2.lin1}

    def forward(self, H, edge_index, num_nodes):
        eps = 1e-8
        if self.damping:
            H = H / torch.sqrt((H ** 2).sum(1, keepdim=True) + eps)
        src, dst = edge_index[0], edge_index[1]
        H_i, H_j = _take(H, src), _take(H, dst)
        if self.edgenet:
            curv = F.relu(self.mlp_1(torch.cat([H_i, H_j], dim=1)))
            curv = segment_sum(curv, src, num_nodes)
            curv = torch.cat([_take(curv, src), _take(curv, dst)], dim=1)
            curv = torch.sigmoid(self.mlp_2(curv))
        else:
            curv = self.a.clamp(eps, 1.0) * torch.ones(
                (H_i.shape[0], 1), dtype=H.dtype, device=H.device)
        if self.damping:
            cos = (H_i * H_j).sum(1, keepdim=True)
            H_edge = curv * (H_j - cos * H_i)
        else:
            H_edge = curv * (H_j - H_i)
        dH = segment_mean(H_edge, src, num_nodes)
        if self.damping:
            dH = dH / torch.sqrt((dH ** 2).sum(1, keepdim=True) + eps)
        return dH


class GNRFModel(nn.Module):
    """Graph neural repulsion field (reference gnrf.py:292-372):
    dropout, ``lin_in`` (ReLU), ``num_steps`` RK4 steps of the field
    (``ode_block``) from 0 to ``t_end``, ReLU, dropout, ``lin_out``."""

    def __init__(self, num_class, hidden=64, edgenet=True,
                 channel_curv=False, damping=False, t_end=1.0, num_steps=8,
                 dropout=0.2, in_channels=None):
        super().__init__()
        self.t_end, self.num_steps, self.dropout = t_end, num_steps, dropout
        self.lin_in = lecun_dense(in_channels, hidden)
        self.ode_block = _GNRFFunc(hidden, edgenet, channel_curv, damping)
        self.lin_out = lecun_dense(hidden, num_class)

    def flax_tree(self):
        return {"lin_in": self.lin_in, "ode_block": self.ode_block,
                "lin_out": self.lin_out}

    def forward(self, x, edge_index, num_nodes=None, generator=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        rate = self.dropout if self.training else 0.0
        h = F.relu(lecun_apply(self.lin_in, dropout(x, rate, generator)))
        h = odeint_rk4(lambda t, y: self.ode_block(y, edge_index, num_nodes),
                       h, 0.0, self.t_end, self.num_steps)
        return lecun_apply(self.lin_out, dropout(F.relu(h), rate, generator))


def grace_pot_bounds(edge_index_np, num_nodes, local_changes=5):
    """Entry-wise adjacency-perturbation bounds for the POT certificate
    (reference grace_pot.py:118-133), on the host in numpy: A_upper from
    the worst-case deletion of each node's edges, A_lower the diagonal
    1 / (deg + 1). Returns dense (N, N) float32 arrays."""
    src, dst = np.asarray(edge_index_np)
    und = np.concatenate([np.stack([src, dst]), np.stack([dst, src])],
                         axis=1)
    deg = np.bincount(und[1], minlength=num_nodes).astype(np.float64) / 2
    A = np.zeros((num_nodes, num_nodes), np.float32)
    A[src, dst] = 1.0
    A_tilde = A + np.eye(num_nodes, dtype=np.float32)
    degs_tilde = deg + 1
    max_delete = np.maximum(degs_tilde.astype(int) - 2, 0)
    max_delete = np.minimum(max_delete, np.round(local_changes * deg))
    s = 1 / np.sqrt(degs_tilde - max_delete)
    A_upper = np.where(A_tilde > 0, s * s[:, None], 0.0).astype(np.float32)
    A_lower = np.diag((1 / (deg + 1)).astype(np.float32))
    return A_upper, A_lower


def _gcn_stack(num_hidden, k, in_channels):
    """k GCNConvs, 2 * num_hidden wide but the last, num_hidden."""
    dims = [in_channels] + [2 * num_hidden] * (k - 1) + [num_hidden]
    return nn.ModuleList(GCNConv(a, b) for a, b in zip(dims, dims[1:]))


class GracePOTModel(nn.Module):
    """GRACE-POT (reference grace_pot.py:36-190): a GRACE encoder of ``k``
    ReLU GCNConvs (``conv{i}``) and projection (``fc1``, ELU, ``fc2``),
    `loss` the GRACE objective between two views, and the POT certificate
    score of a node subset (`pot_score`, on the bounds of
    `grace_pot_bounds`) with its hinge (`pot_loss`)."""

    def __init__(self, num_hidden, num_proj_hidden, tau=0.5, k=2,
                 in_channels=None):
        super().__init__()
        self.tau = tau
        self.convs = _gcn_stack(num_hidden, k, in_channels)
        self.fc1 = lecun_dense(num_hidden, num_proj_hidden)
        self.fc2 = lecun_dense(num_proj_hidden, num_hidden)

    def flax_tree(self):
        tree = {f"conv{i}": c for i, c in enumerate(self.convs)}
        tree.update({"fc1": self.fc1, "fc2": self.fc2})
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        h = x
        for conv in self.convs:
            h = F.relu(conv(h, edge_index, edge_weight, num_nodes))
        return h

    def project(self, z):
        return lecun_apply(self.fc2, F.elu(lecun_apply(self.fc1, z)))

    def loss(self, x1, ei1, w1, x2, ei2, w2, num_nodes=None):
        z1 = self(x1, ei1, w1, num_nodes)
        z2 = self(x2, ei2, w2, num_nodes)
        return grace_loss(self.project(z1), self.project(z2), self.tau)

    @staticmethod
    def pot_score(z2, A_add, A_sub, XW, HW):
        """Linear-relaxation POT score of a node subset (reference
        grace_pot.py:106-190, ReLU activations): ``A_add`` / ``A_sub`` the
        (B, B) half sum and half difference of the upper and lower bound
        matrices over the subset, ``XW`` / ``HW`` the pre-activations."""
        z1_U = A_add @ XW + A_sub @ XW.abs()
        z2_U = A_add @ HW + A_sub @ HW.abs()
        z1_L = A_add @ XW - A_sub @ XW.abs()
        z2_L = A_add @ HW - A_sub @ HW.abs()

        def alpha_beta(low, up):
            pos, neg = low >= 0, up <= 0
            mid = ~(pos | neg)
            denom = torch.where(mid, up - low, torch.ones_like(up))
            alpha = torch.where(pos, torch.ones_like(up),
                                torch.where(mid, up / denom,
                                            torch.zeros_like(up)))
            beta_u = torch.where(mid, -up * low / up.clamp_min(1e-12),
                                 torch.zeros_like(up))
            return alpha, beta_u

        n = z2.shape[0]
        z2n = _unit_rows(z2)
        Wcl = z2n * (n / (n - 1)) - z2n.sum(0) / (n - 1)
        a2, b2 = alpha_beta(z2_L, z2_U)
        a1, _ = alpha_beta(z1_L, z1_U)
        return (a2 * Wcl * (a1 * z1_U + b2)).sum(1)

    @staticmethod
    def pot_loss(score):
        """The certificate's hinge, -mean log sigmoid(score) (reference
        grace_pot.py:188-189)."""
        return -F.logsigmoid(score).mean()


class GraceSpcoModel(nn.Module):
    """GRACE-Spco (reference grace_spco.py:41-104): GRACE over
    edge-weighted views, the weights threaded through each of the ``k``
    ReLU GCNConvs (``conv{i}``); projection ``Dense_0``, ELU, ``Dense_1``.
    Without a second view the forward returns the first view's
    embeddings."""

    def __init__(self, num_hidden, num_proj_hidden, tau=0.5, k=2,
                 in_channels=None):
        super().__init__()
        self.tau = tau
        self.convs = _gcn_stack(num_hidden, k, in_channels)
        self.proj0 = lecun_dense(num_hidden, num_proj_hidden)
        self.proj1 = lecun_dense(num_proj_hidden, num_hidden)

    def flax_tree(self):
        tree = {f"conv{i}": c for i, c in enumerate(self.convs)}
        tree.update({"Dense_0": self.proj0, "Dense_1": self.proj1})
        return tree

    def _encode(self, h, ei, w, num_nodes):
        for conv in self.convs:
            h = F.relu(conv(h, ei, w, num_nodes))
        return h

    def forward(self, x1, ei1, w1, x2=None, ei2=None, w2=None,
                num_nodes=None):
        z1 = self._encode(x1, ei1, w1, num_nodes)
        if x2 is None:
            return z1
        z2 = self._encode(x2, ei2, w2, num_nodes)

        def proj(z):
            return lecun_apply(self.proj1, F.elu(lecun_apply(self.proj0, z)))
        return grace_loss(proj(z1), proj(z2), self.tau)
