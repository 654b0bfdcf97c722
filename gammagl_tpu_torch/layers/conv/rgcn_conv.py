"""RGCNConv (Schlichtkrull et al. 2018), counterpart of
`gammagl_tpu/layers/conv/rgcn_conv.py`.

out[d] = sum_{(s, d, r)} x[s] W_r + x[d] root + bias. As in the JAX layer,
every relation's map is applied to every node up front (h_all (R, N, out))
and each edge reads its message from the flat (R*N, out) table at
``edge_type * N + src``: one gather and one sum whatever the number of
relations. Two routes compute the same function:

* with a `CSRPlan` of the edges: the messages are gathered in the plan's
  CSR order and summed into their destinations by `segment_sum_csr`, the
  per-edge form of the CSR kernel on the card (its backward is the expand
  kernel);
* without one: the COO route, `segment_sum` in plain PyTorch.
"""

import torch
from torch import nn

from gammagl_tpu_torch.layers.conv.message_passing import MessagePassing
from gammagl_tpu_torch.layers.conv.gat_conv import truncated_normal_
from gammagl_tpu_torch.ops import segment_sum, segment_sum_csr

__all__ = ["RGCNConv"]


class RGCNConv(MessagePassing):
    """Relation-typed graph convolution over ``num_relations`` relations.

    The relation maps take one of three forms, as in flax:
    ``num_bases``: ``weight`` (bases, in, out) mixed by ``base_att``
    (relations, bases); ``num_blocks``: block-diagonal ``weight``
    (relations, blocks, in/blocks, out/blocks); neither: ``weight``
    (relations, in, out). Then ``root`` (in, out) when ``root_weight`` and
    ``bias`` (out,) when ``add_bias``. All float32, truncated_normal(0.02)
    as in flax; the layer computes in x's dtype promoted with theirs.
    """

    def __init__(self, in_channels, out_channels, num_relations,
                 num_bases=None, num_blocks=None, root_weight=True,
                 add_bias=True):
        super().__init__()
        R, Fi, Fo = num_relations, in_channels, out_channels
        self.num_relations = R
        self.out_channels = Fo
        self.num_bases, self.num_blocks = num_bases, num_blocks
        self.base_att = None
        if num_bases is not None:
            self.weight = nn.Parameter(torch.empty(num_bases, Fi, Fo))
            self.base_att = nn.Parameter(torch.empty(R, num_bases))
        elif num_blocks is not None:
            if Fi % num_blocks or Fo % num_blocks:
                raise ValueError(f"{num_blocks} blocks do not divide the "
                                 f"widths {Fi} -> {Fo}")
            B = num_blocks
            self.weight = nn.Parameter(torch.empty(R, B, Fi // B, Fo // B))
        else:
            self.weight = nn.Parameter(torch.empty(R, Fi, Fo))
        self.root = (nn.Parameter(torch.empty(Fi, Fo)) if root_weight
                     else None)
        self.bias = nn.Parameter(torch.empty(Fo)) if add_bias else None
        for p in (self.weight, self.base_att, self.root, self.bias):
            if p is not None:
                truncated_normal_(p)

    def flax_tree(self):
        names = ("weight", "base_att", "root", "bias")
        return {n: getattr(self, n) for n in names
                if getattr(self, n) is not None}

    def _transform(self, x):
        """Every relation's map of every node: (R, N, out)."""
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        x, w = x.to(dtype), self.weight.to(dtype)
        if self.base_att is not None:
            w = torch.einsum("rb,bio->rio", self.base_att.to(dtype), w)
        elif self.num_blocks is not None:
            B = self.num_blocks
            h = torch.einsum("nbi,rbio->rnbo", x.reshape(x.shape[0], B, -1),
                             w)
            return h.reshape(self.num_relations, x.shape[0], -1)
        return torch.einsum("ni,rio->rno", x, w)

    def forward(self, x, edge_index, edge_type, num_nodes=None, plan=None):
        """x (N, in), edge_index (2, E), edge_type (E,) -> (num_nodes, out);
        ``plan`` a `CSRPlan` of the edges sends the sum to the kernel."""
        if num_nodes is None:
            num_nodes = x.shape[0]
        R, n_src = self.num_relations, x.shape[0]
        flat = self._transform(x).reshape(R * n_src, self.out_channels)
        if plan is not None:
            _, col, perm = plan.arrays(x.device)
            idx = edge_type[perm].long() * n_src + col.long()
            out = segment_sum_csr(flat[idx.clamp(max=R * n_src - 1)], plan)
        else:
            src, dst = edge_index[0].long(), edge_index[1].long()
            idx = edge_type.long() * n_src + src.clamp(max=n_src - 1)
            out = segment_sum(flat[idx.clamp(max=R * n_src - 1)], dst,
                              num_nodes)
        if self.root is not None:
            out = out + x[:num_nodes].to(out.dtype) @ self.root.to(out.dtype)
        if self.bias is not None:
            out = out + self.bias
        return out
