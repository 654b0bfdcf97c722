"""HeteroConv, HANConv (Wang et al. 2019), HGTConv (Hu et al. 2020) and
SimpleHGNConv (Lv et al. 2021), counterparts of
`gammagl_tpu/layers/conv/hetero_conv.py`.

`HANConv` runs one `GATConv` a relation (each on its relation's plan from
``plan_dict``, so on the card through the flash kernels) and blends the
outputs that land on a node type by one shared semantic attention,
`SemAttAggr`.

`SimpleHGNConv` scores each edge by GAT's two endpoint terms plus a
learned edge-type term, and returns its attention weights for the next
layer's residual blend. With a `CSRPlan` the weights are held in the
plan's CSR order: the endpoint scores gathered per edge (the source side
by `gather_rows`, the destination side by the expand kernel), the softmax
by `segment_softmax_padded` and the multi-head sum by `bspmm_csr` (one CSR
SpMM a head, its dalpha the SDDMM); without one, in the caller's edge
order by `segment_softmax` and `bspmm`.

`HGTConv` computes, per relation (src_type, rel, dst_type) and head h,

    k = k_src a_rel,  v = v_src m_rel
    s_e = <q[dst_e], k[src_e]> pri / sqrt(D)
    out[d] = sum_e softmax_d(s)_e v[src_e]

then sums the relations landing on a type, applies GELU (tanh form, as
``jax.nn.gelu``), a per-type linear map and, where the widths allow, a
learned skip blend. It takes one of three routes, under the JAX layer's
own conditions (`hetero_conv.py:187-246`), so the same call takes the same
route in both packages:

* **fused**: a relation with a window plan (``plan.window``), bf16 k,
  (H*D) % 128 == 0, D dividing 128 or a multiple of it, and no dropout in
  force: `hgt_flash_packed`, one kernel forward and one backward;
* **decomposed**: any other relation with a plan: the source rows
  gathered (`gather_rows`), q expanded to the edges (`expand_dst_csr`),
  the scores in plain PyTorch and softmax and sum in one
  `flash_softmax_spmm_mh` (the JAX layer loops over heads with the
  single-head op; it is the same function);
* **COO**: no plan: plain PyTorch, `segment_softmax` and `segment_sum`.

Attention dropout (training mode, ``dropout_rate > 0``) draws a keep mask
per relation from ``generator`` in the plan's CSR order (edges stably
sorted by destination), as `GATV2Conv` does: the decomposed route reads it
as drawn and the COO route scatters it into edge order, so one generator
state gives both routes the same mask.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.gat_conv import GATConv
from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.dense import (dense, glorot_uniform_,
                                            lecun_linear_, lecun_normal_)
from gammagl_tpu_torch.ops import (bspmm, expand_dst_csr,
                                   flash_softmax_spmm_mh, gather_rows,
                                   hgt_flash_packed, segment_softmax,
                                   segment_sum)
from gammagl_tpu_torch.ops.cuda import (attention_keep_mask, bspmm_csr,
                                        plan_gather_dst, plan_gather_src,
                                        segment_softmax_padded)
from gammagl_tpu_torch.utils.compute_dtype import resolve_dtype

__all__ = ["HeteroConv", "HANConv", "HGTConv", "SimpleHGNConv"]


def _group(values, aggr):
    """Combine the per-relation outputs that land on one node type."""
    if len(values) == 1:
        return values[0]
    if aggr == "cat":
        return torch.cat(values, dim=-1)
    stacked = torch.stack(values, dim=0)
    if aggr == "sum":
        return stacked.sum(0)
    if aggr == "mean":
        return stacked.mean(0)
    if aggr == "max":
        return stacked.amax(0)
    raise ValueError(f"unknown aggr {aggr!r}")


def _name(et):
    return "__".join(et)


def _fan_in(in_channels, node_type):
    """A layer's in-features for one node type: ``in_channels`` is an int,
    a dict by node type, or None (lazy)."""
    if isinstance(in_channels, dict):
        return in_channels.get(node_type)
    return in_channels


def _type_rows(table, edge_type):
    """``table[edge_type]`` for a table of a few rows (one an edge type),
    as one masked select a type: its gradient is then one reduction over
    the edges a type. (PyTorch's indexing backward serializes on so few
    distinct rows: on an H100 it took 1.10 s of a 1.20 s SimpleHGN step at
    5M edges and 3 types; with the selects the step takes 0.10 s.)"""
    out = table[0].expand(edge_type.shape[0], -1)
    for t in range(1, table.shape[0]):
        out = torch.where((edge_type == t)[:, None], table[t], out)
    return out


def _csr_order_keep(layer, generator, edge_index, plan, device):
    """An attention keep mask (E, H) float32 for ``layer`` (its
    ``dropout_rate`` and ``heads``), or None outside training. It is drawn
    in the plan's CSR order (edges stably sorted by destination) and
    returned in the order the route reads: CSR with a plan, the caller's
    edge order without, so one generator state gives both routes the same
    mask."""
    if not layer.training or layer.dropout_rate == 0:
        return None
    csr = attention_keep_mask(generator, layer.dropout_rate,
                              (edge_index.shape[1], layer.heads),
                              device=device)
    if plan is not None:
        return csr
    perm = torch.argsort(edge_index[1], stable=True)
    return torch.empty_like(csr).index_copy_(0, perm, csr)


class HeteroConv(nn.Module):
    """One conv per edge type, outputs combined per destination node type
    by ``aggr``. ``convs`` maps (src, rel, dst) to a module called as
    ``conv(x or (x_src, x_dst), edge_index, num_nodes=n_dst)``; flax names
    each ``convs_('src', 'rel', 'dst')``, as flax names a dict attribute's
    modules."""

    def __init__(self, convs, aggr="sum"):
        super().__init__()
        self.edge_types = [tuple(et) for et in convs]
        self.convs = nn.ModuleDict({_name(et): conv
                                    for et, conv in convs.items()})
        self.aggr = aggr

    def flax_tree(self):
        return {f"convs_{et}": self.convs[_name(et)]
                for et in self.edge_types}

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None):
        out_lists = {}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            x_in = (x_dict[src_t] if src_t == dst_t
                    else (x_dict[src_t], x_dict[dst_t]))
            out = self.convs[_name(et)](x_in, edge_index_dict[et],
                                        num_nodes=n_dst)
            out_lists.setdefault(dst_t, []).append(out)
        return {k: _group(v, self.aggr) for k, v in out_lists.items()}


class SemAttAggr(nn.Module):
    """Semantic attention over the outputs of several relations (HAN's
    metapaths): z (M, N, F) -> (N, F), their sum weighted by a softmax over
    M of each relation's mean score tanh(z W + b) q. Flax names
    ``Dense_0`` (F -> ``hidden_size``, with bias) and ``Dense_1``
    (``hidden_size`` -> 1, no bias), lecun-normal kernels and zero bias."""

    def __init__(self, in_channels, hidden_size):
        super().__init__()
        self.lin = lecun_linear_(nn.Linear(in_channels, hidden_size))
        self.att = lecun_linear_(nn.Linear(hidden_size, 1, bias=False))

    def flax_tree(self):
        return {"Dense_0": self.lin, "Dense_1": self.att}

    def forward(self, z):
        w = torch.tanh(dense(self.lin, z, None, lecun_normal_))
        w = dense(self.att, w, None, lecun_normal_)  # (M, N, 1)
        beta = torch.softmax(w.mean(1), dim=0)  # (M, 1)
        return (beta[:, None, :] * z).sum(0)


class HANConv(nn.Module):
    """Heterogeneous graph attention over ``metadata`` = (node types, edge
    types): one `GATConv` a relation (``heads`` heads of ``out_channels``,
    concatenated; flax names ``gat__{src}__{rel}__{dst}``), a ReLU, and
    for each node type the outputs of its relations blended by ONE
    `SemAttAggr` shared by every type (``SemAttAggr_0``, hidden size
    ``out_channels``), as in the JAX layer.

    ``in_channels``: an int, a dict by node type (the source type's width
    goes to its relations' GATs), or None for lazy maps. The GATs compute
    in the process default dtype (`utils.compute_dtype`), as the JAX layer
    leaves them. ``plan_dict`` {edge type: CSRPlan} sends each relation to
    the flash kernels; ``generator`` draws each GAT's attention mask in
    training mode, one relation after another in ``metadata`` order.
    """

    def __init__(self, in_channels, out_channels, metadata, heads=1,
                 negative_slope=0.2, dropout_rate=0.0):
        super().__init__()
        self.edge_types = [tuple(et) for et in metadata[1]]
        self.gat = nn.ModuleDict({
            _name(et): GATConv(_fan_in(in_channels, et[0]), out_channels,
                               heads=heads, concat=True,
                               negative_slope=negative_slope,
                               dropout_rate=dropout_rate)
            for et in self.edge_types})
        self.sem = SemAttAggr(heads * out_channels, out_channels)

    def flax_tree(self):
        tree = {f"gat__{_name(et)}": self.gat[_name(et)]
                for et in self.edge_types}
        tree["SemAttAggr_0"] = self.sem
        return tree

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None,
                plan_dict=None, generator=None):
        """x_dict {type: (N_t, in)} -> {receiving type: (N_t, H*out)}."""
        out_lists = {nt: [] for nt in x_dict}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            out = self.gat[_name(et)](
                x_dict[src_t], edge_index_dict[et], num_nodes=n_dst,
                plan=plan_dict.get(et) if plan_dict else None,
                generator=generator)
            out_lists[dst_t].append(F.relu(out))
        return {nt: self.sem(torch.stack(outs, 0))
                for nt, outs in out_lists.items() if outs}


class HGTConv(nn.Module):
    """Heterogeneous Graph Transformer layer over ``metadata`` =
    (node types, edge types).

    Parameters, float32 and named as in flax: per node type ``k__{nt}``,
    ``q__{nt}``, ``v__{nt}`` (``nn.Linear`` in -> H*D with bias); per edge
    type ``a_rel__{s__r__d}`` and ``m_rel__...`` (H, D, D) and ``pri__...``
    (H,) ones; per destination type ``out__{nt}`` (H*D -> out) and
    ``skip__{nt}`` (a scalar, 1). Kernels glorot-uniform, biases zero.
    ``in_channels``: an int, a dict by node type, or None for lazy
    projections. ``dtype`` is the compute dtype of the projections and
    attention (None: the process default); the output layer promotes, as
    flax's ``Dense`` without a dtype does, so it gives float32.
    """

    def __init__(self, in_channels, out_channels, metadata, heads=1,
                 dropout_rate=0.2, dtype=None):
        super().__init__()
        self.out_channels = out_channels
        self.heads = heads
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.node_types = list(metadata[0])
        self.edge_types = [tuple(et) for et in metadata[1]]
        H, D = heads, out_channels // heads
        HD = H * D

        def proj(nt):
            fan_in = _fan_in(in_channels, nt)
            return (nn.LazyLinear(HD) if fan_in is None
                    else nn.Linear(fan_in, HD))

        self.k_lin = nn.ModuleDict({nt: proj(nt) for nt in self.node_types})
        self.q_lin = nn.ModuleDict({nt: proj(nt) for nt in self.node_types})
        self.v_lin = nn.ModuleDict({nt: proj(nt) for nt in self.node_types})
        names = [_name(et) for et in self.edge_types]
        self.a_rel = nn.ParameterDict(
            {n: nn.Parameter(torch.empty(H, D, D)) for n in names})
        self.m_rel = nn.ParameterDict(
            {n: nn.Parameter(torch.empty(H, D, D)) for n in names})
        self.pri = nn.ParameterDict(
            {n: nn.Parameter(torch.ones(H)) for n in names})
        receivers = [nt for nt in self.node_types
                     if any(et[2] == nt for et in self.edge_types)]
        self.out_lin = nn.ModuleDict(
            {nt: nn.Linear(HD, out_channels) for nt in receivers})
        self.skip = nn.ParameterDict(
            {nt: nn.Parameter(torch.ones(())) for nt in receivers})
        self.reset_parameters()

    def _linears(self):
        for group in (self.k_lin, self.q_lin, self.v_lin, self.out_lin):
            yield from group.values()

    def reset_parameters(self):
        for lin in self._linears():
            if not isinstance(lin.weight, UninitializedParameter):
                glorot_uniform_(lin.weight)
                nn.init.zeros_(lin.bias)
        for p in list(self.a_rel.values()) + list(self.m_rel.values()):
            glorot_uniform_(p)

    def flax_tree(self):
        tree = {}
        for nt in self.node_types:
            tree[f"k__{nt}"] = self.k_lin[nt]
            tree[f"q__{nt}"] = self.q_lin[nt]
            tree[f"v__{nt}"] = self.v_lin[nt]
        for et in self.edge_types:
            n = _name(et)
            tree[f"a_rel__{n}"] = self.a_rel[n]
            tree[f"m_rel__{n}"] = self.m_rel[n]
            tree[f"pri__{n}"] = self.pri[n]
        for nt in self.out_lin:
            tree[f"out__{nt}"] = self.out_lin[nt]
            tree[f"skip__{nt}"] = self.skip[nt]
        return tree

    def _fused(self, plan, k):
        H, D = self.heads, self.out_channels // self.heads
        return (plan.window and k.dtype == torch.bfloat16
                and (H * D) % 128 == 0 and (128 % D == 0 or D % 128 == 0)
                and (self.dropout_rate == 0 or not self.training))

    def forward(self, x_dict, edge_index_dict, num_nodes_dict=None,
                plan_dict=None, generator=None):
        """x_dict {type: (N_t, in)} -> {receiving type: (N_t, out)}.
        ``plan_dict`` {edge type: CSRPlan} picks each relation's route;
        ``generator`` draws the attention masks in training mode."""
        H, D = self.heads, self.out_channels // self.heads
        HD = H * D
        dtype = resolve_dtype(self.dtype)
        k_dict, q_dict, v_dict = {}, {}, {}
        for nt in self.node_types:
            if nt in x_dict:
                for out, lins in ((k_dict, self.k_lin), (q_dict, self.q_lin),
                                  (v_dict, self.v_lin)):
                    out[nt] = dense(lins[nt], x_dict[nt], dtype,
                                    glorot_uniform_).view(-1, H, D)

        out_lists = {nt: [] for nt in x_dict}
        for et in self.edge_types:
            if et not in edge_index_dict:
                continue
            src_t, _, dst_t = et
            n = _name(et)
            a_rel, m_rel, pri = self.a_rel[n], self.m_rel[n], self.pri[n]
            if dtype is not None:
                a_rel, m_rel = a_rel.to(dtype), m_rel.to(dtype)
            ei = edge_index_dict[et]
            n_dst = (num_nodes_dict[dst_t] if num_nodes_dict
                     else x_dict[dst_t].shape[0])
            k = torch.einsum("nhd,hde->nhe", k_dict[src_t], a_rel)
            v = torch.einsum("nhd,hde->nhe", v_dict[src_t], m_rel)
            q = q_dict[dst_t]
            plan = plan_dict.get(et) if plan_dict else None
            if plan is not None and self._fused(plan, k):
                kv = torch.cat([k.reshape(-1, HD), v.reshape(-1, HD)], 1)
                scale = pri.float() / math.sqrt(D)
                q_scaled = (q.float() * scale[None, :, None]).to(
                    torch.bfloat16)
                out = hgt_flash_packed(kv, q_scaled, plan)
            elif plan is not None:
                packed = torch.cat([k.reshape(-1, HD), v.reshape(-1, HD)], 1)
                g = gather_rows(packed, plan, "src")
                q_e = expand_dst_csr(q.reshape(-1, HD), plan).view(-1, H, D)
                k_e = g[:, :HD].reshape(-1, H, D)
                score = (q_e * k_e).sum(-1) * pri / math.sqrt(D)
                keep = _csr_order_keep(self, generator, ei, plan,
                                       score.device)
                out = flash_softmax_spmm_mh(score, g[:, HD:].reshape(-1, H, D),
                                            plan, keep)
            else:
                src, dst = ei[0].long(), ei[1].long()
                k_e = k[src.clamp(0, k.shape[0] - 1)]
                v_e = v[src.clamp(0, v.shape[0] - 1)]
                q_e = q[dst.clamp(0, q.shape[0] - 1)]
                score = (q_e * k_e).sum(-1) * pri / math.sqrt(D)
                alpha = segment_softmax(score, dst, n_dst)
                keep = _csr_order_keep(self, generator, ei, None,
                                       score.device)
                if keep is not None:
                    alpha = alpha * keep
                out = segment_sum(v_e * alpha[..., None], dst, n_dst)
            out_lists[dst_t].append(out.reshape(-1, HD))

        out_dict = {}
        for nt, outs in out_lists.items():
            if not outs:
                continue
            agg = F.gelu(_group(outs, "sum"), approximate="tanh")
            lin = self.out_lin[nt]
            agg = F.linear(agg.to(torch.promote_types(agg.dtype,
                                                      lin.weight.dtype)),
                           lin.weight, lin.bias)
            x = x_dict[nt]
            if x.shape[-1] == self.out_channels:
                beta = torch.sigmoid(self.skip[nt])
                agg = beta * agg + (1 - beta) * x
            out_dict[nt] = agg
        return out_dict


class SimpleHGNConv(MessagePassing):
    """Simple-HGN attention layer over a graph whose edges carry a type.

    h = x W (``Dense_0``, in -> H*F, no bias), then per edge and head the
    score leaky_relu(<h_src, att_l> + <h_dst, att_r> + <edge_emb[type],
    att_e>), its softmax over each destination's edges, blended with the
    previous layer's weights (``alpha_prev``) as (1 - beta) alpha + beta
    alpha_prev, attention dropout in training mode, the weighted sum of
    h_src, and the residual x W_res (``Dense_1``, when ``residual``).
    Parameters float32, glorot-uniform, named as in flax: ``Dense_0``,
    ``edge_emb`` (num_etypes, H*edge_dim), ``att_l`` and ``att_r`` (1, H,
    F), ``att_e`` (1, H, edge_dim), ``Dense_1``. ``in_channels=None``
    makes both maps lazy. Like the JAX layer it has no compute dtype.

    Returns (out (num_nodes, H*F), alpha (E, H)): alpha in the plan's CSR
    order with a plan, the caller's edge order without, the order
    ``alpha_prev`` must come in. A mask drawn from ``generator`` is drawn
    in CSR order on both routes (see `_csr_order_keep`).
    """

    def __init__(self, in_channels, out_channels, num_etypes, heads=1,
                 edge_dim=32, negative_slope=0.2, dropout_rate=0.0,
                 residual=True, beta=0.05):
        super().__init__()
        self.out_channels, self.heads = out_channels, heads
        self.edge_dim, self.negative_slope = edge_dim, negative_slope
        self.dropout_rate, self.beta = dropout_rate, beta
        width = heads * out_channels

        def linear():
            return (nn.LazyLinear(width, bias=False) if in_channels is None
                    else nn.Linear(in_channels, width, bias=False))

        self.lin = linear()
        self.edge_emb = nn.Parameter(torch.empty(num_etypes,
                                                 heads * edge_dim))
        self.att_l = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_r = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_e = nn.Parameter(torch.empty(1, heads, edge_dim))
        self.res = linear() if residual else None
        for p in (self.edge_emb, self.att_l, self.att_r, self.att_e):
            glorot_uniform_(p)
        for lin in (self.lin, self.res):
            if lin is not None and not isinstance(lin.weight,
                                                  UninitializedParameter):
                glorot_uniform_(lin.weight)

    def flax_tree(self):
        tree = {"Dense_0": self.lin, "edge_emb": self.edge_emb,
                "att_l": self.att_l, "att_r": self.att_r,
                "att_e": self.att_e}
        if self.res is not None:
            tree["Dense_1"] = self.res
        return tree

    def forward(self, x, edge_index, edge_type, num_nodes=None,
                alpha_prev=None, plan=None, generator=None):
        H, Fo = self.heads, self.out_channels
        if num_nodes is None:
            num_nodes = x.shape[0]
        h = dense(self.lin, x, None, glorot_uniform_).view(-1, H, Fo)
        # each score term per node (or per edge type), then gathered per
        # edge: the JAX layer's per-edge dots of gathered rows, the same
        # products and sums
        s_l = (h * self.att_l).sum(-1)
        s_r = (h * self.att_r).sum(-1)
        s_e = (self.edge_emb.view(-1, H, self.edge_dim)
               * self.att_e).sum(-1)
        if plan is not None:
            etype = edge_type[plan.arrays(x.device)[2]]
            score = (plan_gather_src(s_l, plan) + plan_gather_dst(s_r, plan)
                     + _type_rows(s_e, etype))
            alpha = segment_softmax_padded(
                F.leaky_relu(score, self.negative_slope), plan)
        else:
            n = h.shape[0]
            src, dst = edge_index[0].long(), edge_index[1].long()
            score = (s_l[src.clamp(max=n - 1)] + s_r[dst.clamp(max=n - 1)]
                     + _type_rows(s_e, edge_type))
            alpha = segment_softmax(F.leaky_relu(score, self.negative_slope),
                                    dst, num_nodes)
        if alpha_prev is not None:
            alpha = (1 - self.beta) * alpha + self.beta * alpha_prev
        keep = _csr_order_keep(self, generator, edge_index, plan, x.device)
        if keep is not None:
            alpha = alpha * keep
        out = (bspmm_csr(h, alpha, plan) if plan is not None
               else bspmm(edge_index, alpha, h, num_nodes=num_nodes))
        out = out.reshape(-1, H * Fo)
        if self.res is not None:
            out = out + dense(self.res, x, None, glorot_uniform_)
        return out, alpha
