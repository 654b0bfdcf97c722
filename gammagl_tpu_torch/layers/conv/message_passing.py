"""MessagePassing: the gather -> message -> aggregate -> update protocol.

Counterpart of `gammagl_tpu/layers/conv/message_passing.py`. When a
subclass overrides neither `message` nor `aggregate`, `propagate` takes
the fused path: the COO `spmm`, or with a plan the hand-written kernels on
the card: with a `CSRPlan` (`Graph.csr_plan()`) the CSR SpMM ('sum',
'mean') or segment max ('max'), with a `BlockPairPlan` or `HybridPlan`
(`Graph.auto_plan()`) the block-pair SpMM (with the CSR SpMM for the
hybrid's tail).
"""

from typing import Optional

from torch import nn

from gammagl_tpu_torch.ops import (BlockPairPlan, HybridPlan, segment_count,
                                   segment_max, segment_mean, segment_sum,
                                   spmm, spmm_block_pair, spmm_csr,
                                   spmm_hybrid, spmm_max_csr)

__all__ = ["MessagePassing"]


class MessagePassing(nn.Module):
    """Base class for message-passing layers.

    Subclasses implement `forward` and call ``self.propagate(x,
    edge_index, ...)``; override `message` / `aggregate` / `update` to
    customize.
    """

    def message(self, x, edge_index, edge_weight=None):
        """Per-edge message: the source row, scaled by the edge weight."""
        msg = x[edge_index[0].long().clamp(0, x.shape[0] - 1)]
        if edge_weight is not None:
            msg = msg * edge_weight.reshape((-1,) + (1,) * (msg.dim() - 1))
        return msg

    def aggregate(self, msg, edge_index, num_nodes=None, aggr="sum"):
        """Reduce messages into their destinations."""
        dst = edge_index[1]
        if aggr == "sum":
            return segment_sum(msg, dst, num_nodes)
        if aggr == "mean":
            return segment_mean(msg, dst, num_nodes)
        if aggr == "max":
            return segment_max(msg, dst, num_nodes)
        raise NotImplementedError(f"aggr {aggr!r} not supported")

    def message_aggregate(self, x, edge_index, edge_weight=None, aggr="sum",
                          num_nodes=None, plan=None):
        """Fused message + aggregate, dispatched by the plan's type as the
        JAX layer does: 'sum' and 'mean' ('mean' as a sum with 1/deg(dst)
        edge weights) go to `spmm_csr` with a `CSRPlan`, to
        `spmm_block_pair` with a `BlockPairPlan` and to `spmm_hybrid` with
        a `HybridPlan` (`Graph.auto_plan()`); 'max' goes to `spmm_max_csr`
        with a `CSRPlan` and to the COO `spmm` with the other two. Without
        a plan, and for every other aggr ('min') with any plan, the COO
        `spmm(reduce=aggr)` runs, as in the JAX layer."""
        if plan is None or aggr not in ("sum", "mean", "max"):
            return spmm(edge_index, edge_weight, x, num_nodes=num_nodes,
                        reduce=aggr)
        blocked = isinstance(plan, (BlockPairPlan, HybridPlan))
        if aggr == "max":
            if blocked:
                return spmm(edge_index, edge_weight, x, num_nodes=num_nodes,
                            reduce="max")
            return spmm_max_csr(x, edge_weight, plan)
        kernel = (spmm_block_pair if isinstance(plan, BlockPairPlan)
                  else spmm_hybrid if isinstance(plan, HybridPlan)
                  else spmm_csr)
        if aggr == "sum":
            return kernel(x, edge_weight, plan)
        deg = segment_count(edge_index[1], num_nodes)
        inv = deg.reciprocal().masked_fill_(deg == 0, 0.0)
        w = inv[edge_index[1].long()]
        if edge_weight is not None:
            w = w * edge_weight
        return kernel(x, w, plan)

    def update(self, x):
        return x

    def propagate(self, x, edge_index, aggr="sum", edge_weight=None,
                  num_nodes: Optional[int] = None, plan=None, **kwargs):
        if num_nodes is None:
            num_nodes = x.shape[0]
        cls = type(self)
        fused = (cls.message is MessagePassing.message
                 and cls.aggregate is MessagePassing.aggregate)
        if fused:
            out = self.message_aggregate(x, edge_index,
                                         edge_weight=edge_weight, aggr=aggr,
                                         num_nodes=num_nodes, plan=plan)
        else:
            msg = self.message(x, edge_index, edge_weight=edge_weight,
                               **kwargs)
            out = self.aggregate(msg, edge_index, num_nodes=num_nodes,
                                 aggr=aggr)
        return self.update(out)
