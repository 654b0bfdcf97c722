"""DHN, HEAT and CoED convolutions (counterparts of
`gammagl_tpu/layers/conv/wave7_convs.py`; reference:
gammagl/layers/conv/{dhn_conv,heat_conv,coed_conv}.py).

They take no plan, as in the JAX package: HEAT's attention is an edge
softmax and a segment sum grouped by each edge's *source*, CoED's two
channels are COO sums to the destinations and to the sources, all on the
port's COO ops. Each names its flax counterpart's parameters in
``flax_tree`` (`utils.load_jax_params`). The maps are flax ``Dense``s
with glorot-uniform kernels and zero biases; a map whose in-features are
None is lazy and takes them from its first input.
"""

import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv.wave2_convs import _take
from gammagl_tpu_torch.layers.dense import dense, glorot_dense, glorot_uniform_
from gammagl_tpu_torch.ops.segment import segment_sum
from gammagl_tpu_torch.ops.softmax import segment_softmax

__all__ = ["DHNConv", "HEATConv", "CoEDConv"]


def _glorot(lin, x):
    return dense(lin, x, None, glorot_uniform_)


class DHNConv(nn.Module):
    """Distance-encoding heterogeneous network conv (reference
    dhn_conv.py:5-67). Its input is a flat block a sample,
    ``[node (F) | 1-hop (K x F) | 2-hop (K x K x F)]``: the 2-hop rows are
    averaged, joined to their 1-hop row and mapped (``lin1``, ELU), those
    averaged and joined to the node (``lin2``, ELU), then ``lin3`` (ELU).
    """

    def __init__(self, num_fea, num_neighbor, hidden=64):
        super().__init__()
        self.num_fea, self.num_neighbor = num_fea, num_neighbor
        self.lin1 = glorot_dense(2 * num_fea, hidden)
        self.lin2 = glorot_dense(num_fea + hidden, hidden)
        self.lin3 = glorot_dense(hidden, hidden)

    def flax_tree(self):
        return {"lin1": self.lin1, "lin2": self.lin2, "lin3": self.lin3}

    def forward(self, fea):
        K, Fe = self.num_neighbor, self.num_fea
        node = fea[:, :Fe]
        neigh1 = fea[:, Fe:Fe * (K + 1)].reshape(-1, K, Fe)
        neigh2 = fea[:, Fe * (K + 1):].reshape(-1, K, K, Fe)
        tmp = torch.cat([neigh1, neigh2.mean(2)], dim=2)
        tmp = F.elu(_glorot(self.lin1, tmp))
        emb = F.elu(_glorot(self.lin2, torch.cat([node, tmp.mean(1)], 1)))
        return F.elu(_glorot(self.lin3, emb))


class HEATConv(nn.Module):
    """Heterogeneous edge-enhanced graph attention (Mo et al. 2021;
    reference heat_conv.py:7-137).

    Node embeddings (``node_feat_emb``), edge attribute and edge type
    embeddings (``edge_attr_emb``, ``edge_type_emb``, leaky ReLU) score
    each edge per head (``attention_layer``); the scores are a softmax over
    each *source*'s out-edges, and out[src] sums alpha times the message
    ``update_node_emb([edge attr emb, h[dst]])`` (leaky ReLU), the
    reference's outgoing-edge convention. All maps are bias-free. The
    first three maps' in-features are None by default (lazy).
    """

    def __init__(self, in_channels=None, edge_attr_channels=None,
                 edge_type_channels=None, node_emb_size=64,
                 edge_attr_emb_size=64, edge_type_emb_size=64,
                 out_channels=128, heads=3, concat=True, negative_slope=0.2):
        super().__init__()
        self.out_channels, self.heads = out_channels, heads
        self.concat, self.negative_slope = concat, negative_slope
        self.node_feat_emb = glorot_dense(in_channels, node_emb_size,
                                          bias=False)
        self.edge_attr_emb = glorot_dense(edge_attr_channels,
                                          edge_attr_emb_size, bias=False)
        self.edge_type_emb = glorot_dense(edge_type_channels,
                                          edge_type_emb_size, bias=False)
        self.attention_layer = glorot_dense(
            2 * node_emb_size + edge_attr_emb_size + edge_type_emb_size,
            heads, bias=False)
        self.update_node_emb = glorot_dense(
            edge_attr_emb_size + node_emb_size, heads * out_channels,
            bias=False)

    def flax_tree(self):
        return {"node_feat_emb": self.node_feat_emb,
                "edge_attr_emb": self.edge_attr_emb,
                "edge_type_emb": self.edge_type_emb,
                "attention_layer": self.attention_layer,
                "update_node_emb": self.update_node_emb}

    def forward(self, x, edge_index, edge_attr, edge_type, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]

        def lrelu(v):
            return F.leaky_relu(v, self.negative_slope)

        h = _glorot(self.node_feat_emb, x)
        e_attr = lrelu(_glorot(self.edge_attr_emb, edge_attr))
        e_type = lrelu(_glorot(self.edge_type_emb, edge_type.to(h.dtype)))
        src, dst = edge_index[0], edge_index[1]
        h_dst = _take(h, dst)
        score = torch.cat([_take(h, src), h_dst, e_attr, e_type], dim=-1)
        alpha = lrelu(_glorot(self.attention_layer, score))  # (E, H)
        alpha = segment_softmax(alpha, src, num_nodes)
        msg = lrelu(_glorot(self.update_node_emb,
                            torch.cat([e_attr, h_dst], dim=-1)))
        msg = msg.reshape(-1, self.heads, self.out_channels)
        out = segment_sum(msg * alpha[:, :, None], src, num_nodes)
        if self.concat:
            return out.reshape(num_nodes, -1)
        return out.mean(1)


class CoEDConv(nn.Module):
    """Directional conv of CoED-GNN (reference coed_conv.py:14-120): the
    forward channel sums x[src] into dst (``lin_src_to_dst``), the reverse
    channel x[dst] into src (``lin_dst_to_src``), and, with
    ``self_feature_transform``, a map of x itself (``lin_self``). Returns
    the two or three outputs. ``edge_weight`` is one (E,) weight for both
    channels, or a (forward, reverse) pair."""

    def __init__(self, in_channels, out_channels, self_feature_transform=True,
                 add_bias=True):
        super().__init__()
        self.self_feature_transform = self_feature_transform
        self.lin_src_to_dst = glorot_dense(in_channels, out_channels,
                                           bias=add_bias)
        self.lin_dst_to_src = glorot_dense(in_channels, out_channels,
                                           bias=add_bias)
        self.lin_self = (glorot_dense(in_channels, out_channels,
                                      bias=add_bias)
                         if self_feature_transform else None)

    def flax_tree(self):
        tree = {"lin_src_to_dst": self.lin_src_to_dst,
                "lin_dst_to_src": self.lin_dst_to_src}
        if self.lin_self is not None:
            tree["lin_self"] = self.lin_self
        return tree

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None):
        if num_nodes is None:
            num_nodes = x.shape[0]
        if isinstance(edge_weight, (tuple, list)):
            w_fwd, w_rev = edge_weight
        else:
            w_fwd = w_rev = edge_weight
        src, dst = edge_index[0], edge_index[1]

        def gather_agg(take_from, scatter_to, w):
            msg = _take(x, take_from)
            if w is not None:
                msg = msg * w.reshape(-1, 1)
            return segment_sum(msg, scatter_to, num_nodes)

        out_fwd = _glorot(self.lin_src_to_dst, gather_agg(src, dst, w_fwd))
        out_rev = _glorot(self.lin_dst_to_src, gather_agg(dst, src, w_rev))
        if self.lin_self is not None:
            return out_fwd, out_rev, _glorot(self.lin_self, x)
        return out_fwd, out_rev
