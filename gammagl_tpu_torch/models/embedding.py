"""Shallow embedding models: DeepWalk, Node2Vec, MetaPath2Vec
(counterpart of `gammagl_tpu/models/embedding.py`).

Reference: gammagl/models/{deepwalk,node2vec,metapath2vec}.py (node2vec.py:12
with pos_sample:88 / neg_sample:99). Walks are drawn on the host
(`loader.random_walk`, or `MetaPath2Vec.sample_walks` in numpy); the
skip-gram objective runs on the embedding table's device. Its gathers
(``emb[walks]``) are COO indexing, as in the JAX package: on the card
their backward is PyTorch's indexed accumulate, not a kernel of the port.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.ops.sparse import ind2ptr_np

__all__ = ["DeepWalk", "Node2Vec", "MetaPath2Vec"]


def _skipgram_loss(emb, pos_walks, neg_walks, context_size):
    """Negative-sampling skip-gram over walk windows: the walk's first
    node (the center) against each of the next ``context_size - 1``.

    emb: (N, D); pos_walks: (B, L) node ids; neg_walks: (B, K, L)."""
    def window_loss(walks, sign):
        center = emb[walks[:, :1]]                     # (B, 1, D)
        context = emb[walks[:, 1:context_size]]        # (B, C-1, D)
        logits = (center * context).sum(-1)
        return -F.logsigmoid(sign * logits).mean()

    pos = window_loss(pos_walks, 1.0)
    neg = window_loss(neg_walks.reshape(-1, neg_walks.shape[-1]), -1.0)
    return pos + neg


def _table(num_nodes, embedding_dim):
    """flax ``normal(1 / D)``: entries of standard deviation 1 / D."""
    return nn.Parameter(torch.randn(num_nodes, embedding_dim)
                        / embedding_dim)


class Node2Vec(nn.Module):
    """Biased-walk skip-gram embeddings (Grover & Leskovec 2016): one
    (num_nodes, embedding_dim) table (flax ``embedding``). The forward
    returns the table, or with walks the skip-gram loss."""

    def __init__(self, num_nodes, embedding_dim=128, walk_length=10,
                 context_size=5, p=1.0, q=1.0, num_negatives=1):
        super().__init__()
        self.num_nodes, self.embedding_dim = num_nodes, embedding_dim
        self.walk_length, self.context_size = walk_length, context_size
        self.p, self.q, self.num_negatives = p, q, num_negatives
        self.embedding = _table(num_nodes, embedding_dim)

    def flax_tree(self):
        return {"embedding": self.embedding}

    def forward(self, pos_walks=None, neg_walks=None):
        if pos_walks is None:
            return self.embedding
        return _skipgram_loss(self.embedding, pos_walks, neg_walks,
                              self.context_size)

    def make_loader(self, edge_index, batch_size=128, seed=None):
        """Host-side walk loader with this model's walk length, negatives
        and (p, q): `loader.random_walk.RandomWalkLoader`."""
        from gammagl_tpu_torch.loader.random_walk import RandomWalkLoader
        return RandomWalkLoader(edge_index, self.num_nodes,
                                batch_size=batch_size,
                                walk_length=self.walk_length,
                                num_negatives=self.num_negatives,
                                p=self.p, q=self.q, seed=seed)


class DeepWalk(Node2Vec):
    """The uniform-walk case (p = q = 1), reference deepwalk.py."""


class MetaPath2Vec(nn.Module):
    """Metapath-guided walks on a typed graph (Dong et al. 2017;
    reference metapath2vec.py:14). One table over the per-type id spaces
    concatenated in sorted type order (flax ``embedding``)."""

    def __init__(self, num_nodes_dict, metapath, embedding_dim=128,
                 walk_length=10, context_size=5, num_negatives=1):
        super().__init__()
        self.num_nodes_dict = dict(num_nodes_dict)
        self.metapath = tuple(tuple(et) for et in metapath)
        self.embedding_dim, self.walk_length = embedding_dim, walk_length
        self.context_size, self.num_negatives = context_size, num_negatives
        self.embedding = _table(self.total_nodes, embedding_dim)

    @property
    def offsets(self):
        out, cursor = {}, 0
        for nt, n in sorted(self.num_nodes_dict.items()):
            out[nt] = cursor
            cursor += n
        return out

    @property
    def total_nodes(self):
        return sum(self.num_nodes_dict.values())

    def flax_tree(self):
        return {"embedding": self.embedding}

    def forward(self, pos_walks=None, neg_walks=None):
        if pos_walks is None:
            return self.embedding
        return _skipgram_loss(self.embedding, pos_walks, neg_walks,
                              self.context_size)

    def embed(self, node_type, ids=None):
        """The rows of ``node_type`` (all, or those of local ``ids``)."""
        lo = self.offsets[node_type]
        block = self.embedding[lo:lo + self.num_nodes_dict[node_type]]
        return block if ids is None else block[ids]

    def sample_walks(self, edge_index_dict, batch_starts, rng=None):
        """Host-side metapath walks from ``batch_starts`` (ids of the first
        relation's source type): follow the relations of ``metapath``
        cyclically for ``walk_length`` steps, a uniform neighbour a step
        from ``rng`` (a numpy Generator); a node without one stays. Returns
        (B, walk_length + 1) int64 global ids, the JAX package's draws."""
        rng = rng or np.random.default_rng()
        csr = {}
        for et, ei in edge_index_dict.items():
            ei = np.asarray(ei)
            order = np.argsort(ei[0], kind="stable")
            n_src = self.num_nodes_dict[et[0]]
            csr[et] = (ind2ptr_np(ei[0][order], n_src), ei[1][order])
        start_type = self.metapath[0][0]
        walks = np.empty((len(batch_starts), self.walk_length + 1),
                         np.int64)
        for i, s in enumerate(np.asarray(batch_starts)):
            cur, cur_t = int(s), start_type
            walks[i, 0] = cur + self.offsets[cur_t]
            for t in range(1, self.walk_length + 1):
                et = self.metapath[(t - 1) % len(self.metapath)]
                rowptr, col = csr[et]
                lo, hi = rowptr[cur], rowptr[cur + 1]
                if hi > lo:
                    cur = int(col[rng.integers(lo, hi)])
                    cur_t = et[2]
                walks[i, t] = cur + self.offsets[cur_t]
        return walks
