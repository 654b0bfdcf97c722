"""The layered neighbour loader: bipartite adjacency blocks a hop
(counterpart of `gammagl_tpu/loader/neighbor_sampler.py`).

Reference: gammagl/loader/neighbor_sampler.py:29, which yields
(batch_size, n_id, [Adj(edge_index, e_id, size), ...]) outermost hop
first, for GraphSAGE_Sample_Model (`models.GraphSAGESampleModel`).

The blocks come from one call into the C++ multi-hop sampler
(`csrc/sampler.cpp`), DGL-MFG style: block l (outermost first) reuses
every sampled edge whose destination takes part in layer l's output.
Edges are emitted hop-major with growing local ids, so each block is a
prefix of the sample. The reference's per-hop re-sampling loop
(`SparseGraph.sample_adj` over the whole frontier, other block sizes) is
the ``use_ext=False`` route, and only that.
"""

from typing import List, NamedTuple, Tuple

import numpy as np

from gammagl_tpu_torch.sampler import NeighborSampler
from gammagl_tpu_torch.sparse import SparseGraph

__all__ = ["Adj", "NeighborSamplerLoader"]


class Adj(NamedTuple):
    edge_index: np.ndarray  # (2, E) local (src, dst)
    e_id: np.ndarray
    size: Tuple[int, int]   # (num_src_nodes, num_dst_nodes)


class NeighborSamplerLoader:
    """Seed batches of ``node_idx`` (an index array or a mask; None: every
    node) of ``batch_size``, shuffled with a ``default_rng(seed)`` when
    ``shuffle``; each yields (batch_size, n_id, adjs). With
    ``presample_chunks`` > 1 the C++ sampler takes that many batches a
    call on its OpenMP threads."""

    def __init__(self, edge_index, node_idx=None, sample_lists=(25, 10),
                 batch_size=1024, num_nodes=None, shuffle=False,
                 seed=None, use_ext=True, presample_chunks=1):
        ei = np.asarray(edge_index)
        if num_nodes is None:
            num_nodes = int(ei.max()) + 1
        self.node_idx = (np.arange(num_nodes) if node_idx is None
                         else np.asarray(node_idx))
        if self.node_idx.dtype == bool:
            self.node_idx = np.nonzero(self.node_idx)[0]
        self.sample_lists = list(sample_lists)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.presample_chunks = max(1, presample_chunks)
        self.rng = np.random.default_rng(seed)
        self._sampler = NeighborSampler(ei, num_nodes, self.sample_lists,
                                        seed=seed, use_ext=use_ext)
        self._legacy = None if self._sampler._ext is not None else \
            SparseGraph(ei[0], ei[1], sparse_sizes=(num_nodes, num_nodes))

    def __len__(self):
        return -(-len(self.node_idx) // self.batch_size)

    def _blocks_from_output(self, out, batch_len):
        """DGL-MFG construction: layer l (outermost first) uses the edges
        of hops 1..L-l, a hop-major prefix, with sizes
        (cum_nodes[L-l], cum_nodes[L-l-1])."""
        hop_n = np.asarray(out.num_sampled_nodes)
        hop_e = np.asarray(out.num_sampled_edges)
        cum_n = np.cumsum(hop_n)
        cum_e = np.cumsum(hop_e)
        L = len(hop_e)
        ei_full = np.stack([out.row, out.col])
        adjs: List[Adj] = []
        for layer in range(L):
            k = L - layer
            e_hi = int(cum_e[k - 1])
            adjs.append(Adj(ei_full[:, :e_hi], out.edge[:e_hi],
                            (int(cum_n[k]), int(cum_n[k - 1]))))
        return batch_len, out.node, adjs

    def sample(self, batch):
        """One minibatch: (batch_size, n_id, adjs), adjs outermost hop
        first (the order of GraphSAGESampleModel's layers)."""
        batch = np.asarray(batch, np.int64)
        if self._legacy is None:
            out = self._sampler.sample_from_nodes(batch)
            return self._blocks_from_output(out, len(batch))
        return self._sample_legacy(batch)

    def _sample_legacy(self, batch):
        adjs: List[Adj] = []
        n_id = np.asarray(batch, np.int64)
        for fanout in self.sample_lists:
            block, n_id_new = self._legacy.sample_adj(
                n_id, fanout, rng=self.rng)
            row, col, e_id = block.coo()
            adjs.append(Adj(np.stack([row, col]), e_id,
                            (len(n_id_new), len(n_id))))
            n_id = n_id_new
        return len(batch), n_id, adjs[::-1]

    def __iter__(self):
        order = self.node_idx.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        seed_batches = [order[lo:lo + bs] for lo in range(0, len(order), bs)]
        if self._legacy is None and self.presample_chunks > 1:
            for lo in range(0, len(seed_batches), self.presample_chunks):
                chunk = seed_batches[lo:lo + self.presample_chunks]
                outs = self._sampler.sample_from_nodes_many(chunk)
                for b, out in zip(chunk, outs):
                    yield self._blocks_from_output(out, len(b))
        else:
            for b in seed_batches:
                yield self.sample(b)
