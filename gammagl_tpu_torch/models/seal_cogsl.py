"""SEAL link prediction and CoGSL structure learning (counterpart of
`gammagl_tpu/models/seal_cogsl.py`).

Reference: gammagl/models/{seal (DGCNN usage), cogsl}.py; DRNL labeling per
the SEAL paper (Zhang & Chen 2018). Both models are COO, as in the JAX
package: SEAL's DGCNN gathers and takes segment maxima, CoGSL's GCNConvs
get no plan.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv
from gammagl_tpu_torch.layers.dense import (fan_in_normal_, lecun_apply,
                                            lecun_dense)
from gammagl_tpu_torch.models.ssl import grace_loss
from gammagl_tpu_torch.models.wave2_models import DGCNNModel

__all__ = ["drnl_node_labeling", "SEALModel", "CoGSLModel"]


def drnl_node_labeling(edge_index, num_nodes, src, dst, max_dist=10):
    """Double-radius node labeling: label(i) = 1 + min(d_s, d_t) +
    (d//2)*((d//2) + (d%2) - 1) with d = d_s + d_t; the two targets get
    label 1, unreachable nodes 0. Host-side BFS over the undirected
    edges, at most ``max_dist`` hops, each search blind to the other
    target (the JAX package's rule: the same int64 labels)."""
    adj = [[] for _ in range(num_nodes)]
    for s, d in np.asarray(edge_index).T:
        adj[int(s)].append(int(d))
        adj[int(d)].append(int(s))

    def bfs(start, blocked):
        dist = np.full(num_nodes, -1, np.int64)
        dist[start] = 0
        frontier = [start]
        depth = 0
        while frontier and depth < max_dist:
            depth += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[v] < 0 and v != blocked:
                        dist[v] = depth
                        nxt.append(v)
            frontier = nxt
        return dist

    ds = bfs(src, dst)
    dt = bfs(dst, src)
    labels = np.zeros(num_nodes, np.int64)
    reach = (ds >= 0) & (dt >= 0)
    d = ds + dt
    half = d // 2
    lab = 1 + np.minimum(ds, dt) + half * (half + d % 2 - 1)
    labels[reach] = lab[reach]
    labels[src] = 1
    labels[dst] = 1
    return labels


class SEALModel(nn.Module):
    """SEAL: DGCNN (one output) over DRNL-labeled enclosing subgraphs. The
    label embedding (flax ``Embed_0``: ``max_label + 1`` rows of
    ``hidden_dim``, labels clipped into it) is concatenated with the node
    features of width ``in_channels`` when there are any
    (``DGCNNModel_0``)."""

    def __init__(self, hidden_dim=32, max_label=64, k=20, in_channels=None):
        super().__init__()
        self.max_label = max_label
        self.embed = nn.Embedding(max_label + 1, hidden_dim)
        # flax's default Embed init: variance_scaling(1, fan_in, normal)
        # over the feature axis
        fan_in_normal_(self.embed.weight, 1.0, fan_in=hidden_dim)
        self.dgcnn = DGCNNModel(hidden_dim=hidden_dim, num_class=1, k=k,
                                in_channels=hidden_dim + (in_channels or 0))

    def flax_tree(self):
        return {"Embed_0": self.embed, "DGCNNModel_0": self.dgcnn}

    def forward(self, labels, edge_index, x=None, batch=None,
                num_graphs=None, num_nodes=None):
        z = self.embed(torch.clamp(labels, 0, self.max_label))
        if x is not None:
            z = torch.cat([z, x], dim=-1)
        return self.dgcnn(z, edge_index, batch, num_graphs, num_nodes)


def cogsl_confidence(logits):
    """Per-node softmax margin: the largest probability less the second.
    The two are picked as `jax.lax.top_k` picks them, the lower index
    first among equal values (first maximum, then the first maximum of
    the rest), so at a tie the gradient reaches the same entries as in
    the JAX package."""
    p = F.softmax(logits, -1)
    i1 = torch.argmax(p, -1, keepdim=True)
    rest = p.scatter(-1, i1, float("-inf"))
    i2 = torch.argmax(rest, -1, keepdim=True)
    return (p.gather(-1, i1) - p.gather(-1, i2))[:, 0]


class CoGSLModel(nn.Module):
    """Compact graph structure learning (Liu et al. 2022; reference
    cogsl.py): two view-specific 2-layer GCN encoders (flax ``v1_1``,
    ``v1_2``, ``v2_1``, ``v2_2``) and classifiers (``cls1``, ``cls2``), the
    views fused per node by their confidences (`cogsl_confidence`,
    w1 = c1 / (c1 + c2 + 1e-12)) into a third classifier (``cls_f``).
    Returns ((logits1, logits2, logits_fused), the GRACE loss between
    the two views' embeddings)."""

    def __init__(self, num_class, hidden_dim=32, tau=0.5, in_channels=None):
        super().__init__()
        self.tau = tau
        self.enc = nn.ModuleDict({
            "v1_1": GCNConv(in_channels, hidden_dim),
            "v1_2": GCNConv(hidden_dim, hidden_dim),
            "v2_1": GCNConv(in_channels, hidden_dim),
            "v2_2": GCNConv(hidden_dim, hidden_dim)})
        self.cls = nn.ModuleDict({name: lecun_dense(hidden_dim, num_class)
                                  for name in ("cls1", "cls2", "cls_f")})

    def flax_tree(self):
        return {**self.enc, **self.cls}

    def forward(self, x, ei_view1, ei_view2, num_nodes=None):
        def encode(view, ei):
            h = F.relu(self.enc[f"{view}_1"](x, ei, num_nodes=num_nodes))
            return self.enc[f"{view}_2"](h, ei, num_nodes=num_nodes)

        z1 = encode("v1", ei_view1)
        z2 = encode("v2", ei_view2)
        logits1 = lecun_apply(self.cls["cls1"], z1)
        logits2 = lecun_apply(self.cls["cls2"], z2)
        c1, c2 = cogsl_confidence(logits1), cogsl_confidence(logits2)
        w1 = c1 / (c1 + c2 + 1e-12)
        z_fused = w1[:, None] * z1 + (1 - w1)[:, None] * z2
        logits_f = lecun_apply(self.cls["cls_f"], z_fused)
        return (logits1, logits2, logits_f), grace_loss(z1, z2, self.tau)
