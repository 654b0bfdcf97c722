"""FusedGATConv, MAGCLConv and MGNNI_m_iter (counterparts of
`gammagl_tpu/layers/conv/compat_convs.py`; reference:
gammagl/layers/conv/{fusedgat_conv,magcl_conv,mgnni_m_iter}.py).

- `FusedGATConv` is a `GATConv` that requires a `CSRPlan`: its forward is
  the flash attention kernels (forward and backward) on the card, their
  plain versions on the CPU. ``to_graph_format`` builds the plan, the
  reference's precompute hook.
- `MAGCLConv`: a linear map, then ``k`` normalised propagation steps.
- `MGNNI_m_iter`: ``max_iter`` unrolled iterations of
  Z <- gamma * (A^k Z) g(F) + X, with g(F) = F^T F / (||F^T F||_F + eps).

The last two take no plan, as in JAX: their sums are the COO `spmm`.
"""

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.layers.conv.gat_conv import GATConv, truncated_normal_
from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.ops.cuda import build_csr_plan
from gammagl_tpu_torch.ops.segment import segment_count
from gammagl_tpu_torch.ops.spmm import spmm
from gammagl_tpu_torch.utils.norm import calc_gcn_norm

__all__ = ["FusedGATConv", "MAGCLConv", "MGNNI_m_iter"]


class FusedGATConv(GATConv):
    """`GATConv` pinned to its plan route, the fused flash attention
    kernels::

        plan = FusedGATConv.to_graph_format(edge_index, num_nodes)
        out = conv(x, edge_index, num_nodes, plan=plan)

    Without a plan the forward raises ValueError, as in JAX; `GATConv`
    is the planless layer."""

    @staticmethod
    def to_graph_format(edge_index, num_nodes=None, **kwargs):
        """The `CSRPlan` of ``edge_index`` (host numpy). ``num_nodes``
        defaults to the largest id + 1; ``kwargs`` go to `build_csr_plan`
        (the JAX package's TPU tiling keywords are accepted there and
        ignored)."""
        if isinstance(edge_index, torch.Tensor):
            edge_index = edge_index.cpu().numpy()
        src = np.asarray(edge_index[0])
        dst = np.asarray(edge_index[1])
        if num_nodes is None:
            num_nodes = int(max(src.max(), dst.max())) + 1
        return build_csr_plan(src, dst, num_nodes, **kwargs)

    def forward(self, x, edge_index, num_nodes=None, plan=None, keep=None,
                generator=None):
        if plan is None:
            raise ValueError(
                "FusedGATConv requires the fused plan; precompute it once "
                "with FusedGATConv.to_graph_format(edge_index, num_nodes) "
                "and pass plan=... (use GATConv for the planless path).")
        return super().forward(x, edge_index, num_nodes=num_nodes, plan=plan,
                                keep=keep, generator=generator)


_MAGCL_NORMS = ("both", "left", "right", "none")


class MAGCLConv(MessagePassing):
    """MA-GCL's conv: x @ ``weight`` (in, out), truncated_normal(0.02)
    as in flax (lazy while ``in_channels`` is None), then ``k`` steps of
    A_norm h, then ``bias`` (zeros). ``norm``: 'both' (the GCN norm),
    'right' (1 / in-degree of the destination), 'left' (1 / out-degree of
    the source) or 'none' (the given weights, or ones)."""

    def __init__(self, in_channels, out_channels, norm="both",
                 add_bias=True):
        super().__init__()
        if norm not in _MAGCL_NORMS:
            raise ValueError(f"invalid norm {norm!r}")
        self.out_channels = out_channels
        self.norm = norm
        self.weight = (UninitializedParameter() if in_channels is None
                       else nn.Parameter(truncated_normal_(
                           torch.empty(in_channels, out_channels))))
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if add_bias
                     else None)

    def flax_tree(self):
        tree = {"weight": self.weight}
        if self.bias is not None:
            tree["bias"] = self.bias
        return tree

    def _edge_weights(self, edge_index, edge_weight, num_nodes, dtype):
        if self.norm == "none":
            return (edge_weight if edge_weight is not None else torch.ones(
                edge_index.shape[1], dtype=dtype, device=edge_index.device))
        if self.norm == "both":
            return calc_gcn_norm(edge_index, num_nodes, edge_weight)
        base = (edge_weight if edge_weight is not None else torch.ones(
            edge_index.shape[1], device=edge_index.device))
        ids = edge_index[1 if self.norm == "right" else 0].long()
        deg = segment_count(ids, num_nodes, dtype=base.dtype)
        inv = torch.where(deg > 0, 1.0 / deg, 0.0)
        return base * inv[ids.clamp(0, num_nodes - 1)]

    def forward(self, x, edge_index, k=2, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if isinstance(self.weight, UninitializedParameter):
            with torch.inference_mode(False), torch.no_grad():
                self.weight.materialize((x.shape[-1], self.out_channels))
                truncated_normal_(self.weight)
        h = x @ self.weight.to(torch.promote_types(x.dtype,
                                                   self.weight.dtype))
        ew = self._edge_weights(edge_index, edge_weight, num_nodes,
                                h.dtype).to(h.dtype)
        for _ in range(int(k)):
            h = spmm(edge_index, ew, h, num_nodes=num_nodes)
        if self.bias is not None:
            h = h + self.bias
        return h


class MGNNI_m_iter(nn.Module):  # noqa: N801 - the reference's name
    """MGNNI's implicit multiscale layer: from Z = 0, ``max_iter`` steps of
    Z <- gamma * (A^k Z) g(F) + x, with A the given weights (None: the GCN
    norm) and g(F) = F^T F / (||F^T F||_F + eps); ``F`` (m, m) starts at
    zeros, as in flax. The gradient flows through the unrolled
    iterations."""

    def __init__(self, m, k=1, gamma=0.8, max_iter=25, eps=1e-5):
        super().__init__()
        self.m, self.k, self.gamma = m, k, gamma
        self.max_iter, self.eps = max_iter, eps
        self.F = nn.Parameter(torch.zeros(m, m))

    def flax_tree(self):
        return {"F": self.F}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        """x (N, m), the input injection f(X); returns Z (N, m)."""
        if num_nodes is None:
            num_nodes = x.shape[0]
        ftf = self.F.T @ self.F
        g = ftf / (torch.linalg.norm(ftf) + self.eps)
        ew = (edge_weight if edge_weight is not None
              else calc_gcn_norm(edge_index, num_nodes)).to(x.dtype)
        z = torch.zeros_like(x)
        for _ in range(self.max_iter):
            az = z
            for _ in range(self.k):
                az = spmm(edge_index, ew, az, num_nodes=num_nodes)
            z = self.gamma * az @ g.to(az.dtype) + x
        return z
