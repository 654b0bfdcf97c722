"""HeteroConv and HGTConv (Hu et al. 2020), counterparts of
`gammagl_tpu/layers/conv/hetero_conv.py`.

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

from gammagl_tpu_torch.layers.dense import dense, glorot_uniform_
from gammagl_tpu_torch.ops import (expand_dst_csr, flash_softmax_spmm_mh,
                                   gather_rows, hgt_flash_packed,
                                   segment_softmax, segment_sum)
from gammagl_tpu_torch.ops.cuda import attention_keep_mask
from gammagl_tpu_torch.utils.compute_dtype import resolve_dtype

__all__ = ["HeteroConv", "HGTConv"]


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
            fan_in = (in_channels.get(nt) if isinstance(in_channels, dict)
                      else in_channels)
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

    def _keep(self, generator, edge_index, plan, device):
        """The relation's keep mask (E, H) float32, drawn in CSR order and
        returned in the order the route reads (CSR with a plan, the caller's
        edge order without), or None outside training."""
        if not self.training or self.dropout_rate == 0:
            return None
        csr = attention_keep_mask(generator, self.dropout_rate,
                                  (edge_index.shape[1], self.heads),
                                  device=device)
        if plan is not None:
            return csr
        perm = torch.argsort(edge_index[1], stable=True)
        return torch.empty_like(csr).index_copy_(0, perm, csr)

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
                keep = self._keep(generator, ei, plan, score.device)
                out = flash_softmax_spmm_mh(score, g[:, HD:].reshape(-1, H, D),
                                            plan, keep)
            else:
                src, dst = ei[0].long(), ei[1].long()
                k_e = k[src.clamp(0, k.shape[0] - 1)]
                v_e = v[src.clamp(0, v.shape[0] - 1)]
                q_e = q[dst.clamp(0, q.shape[0] - 1)]
                score = (q_e * k_e).sum(-1) * pri / math.sqrt(D)
                alpha = segment_softmax(score, dst, n_dst)
                keep = self._keep(generator, ei, None, score.device)
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
