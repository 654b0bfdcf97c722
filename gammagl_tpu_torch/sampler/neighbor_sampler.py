"""Host-side fixed-fanout neighbour sampling (counterpart of
`gammagl_tpu/sampler/neighbor_sampler.py`).

Reference algorithm: gammagl/ops/sparse/cpu/neighbor_sample.cpp:22, a
multi-hop fanout loop over the CSC with hash-map relabelling. The C++
sampler (`gammagl_tpu_torch.csrc`) runs it; the numpy route, the same
algorithm with numpy's generator, runs only with ``use_ext=False``.
Samples are host data: seeds are drawn from numpy's ``default_rng``, so
for the same seed both packages draw the same samples on either route.
`sample_neighbors_padded` pads a sample to fixed sizes (node buffers with
``num_nodes``, edges with a destination out of range), which the port's
COO ops drop as the JAX ones do.
"""

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gammagl_tpu_torch.ops.sparse import ind2ptr_np

__all__ = ["SamplerOutput", "NeighborSampler", "sample_neighbors_padded"]


class SamplerOutput(NamedTuple):
    """One sampled subgraph (reference gammagl/sampler/neighbor_sampler.py:206).

    node: (num_sampled,) global ids of sampled nodes (seeds first)
    row/col: (E_s,) local edge endpoints (col = dst local id)
    edge: (E_s,) global edge ids
    batch_size: number of seeds
    num_sampled_nodes / num_sampled_edges: per-hop counts
    """

    node: np.ndarray
    row: np.ndarray
    col: np.ndarray
    edge: np.ndarray
    batch_size: int
    num_sampled_nodes: Optional[List[int]] = None
    num_sampled_edges: Optional[List[int]] = None


def _to_csc(edge_index, num_nodes):
    """Sort edges by dst -> (colptr, row, perm). The stable sort is
    PyTorch's (threaded on the host; a stable sort's permutation is
    unique, so it is numpy's ``argsort(kind="stable")``)."""
    ei = np.asarray(edge_index)
    dst = np.ascontiguousarray(ei[1])
    if not dst.flags.writeable:  # torch.from_numpy wants writable memory
        dst = dst.copy()
    order = torch.from_numpy(dst).argsort(stable=True).numpy()
    colptr = ind2ptr_np(ei[1][order], num_nodes)
    return colptr, ei[0][order], order


class NeighborSampler:
    """Multi-hop fanout sampler over CSC (reference neighbor_sample.cpp:22).

    num_neighbors: fanout per hop; -1 = the full neighbourhood (reference
    behaviour). ``use_ext`` (default) samples with the C++ sampler and
    raises when it does not build; False takes the numpy route.
    """

    def __init__(self, edge_index, num_nodes, num_neighbors: Sequence[int],
                 replace=False, seed=None, use_ext=True):
        self.num_nodes = num_nodes
        self.num_neighbors = list(num_neighbors)
        self.replace = replace
        self.colptr, self.row, self.edge_perm = _to_csc(edge_index,
                                                        num_nodes)
        self.rng = np.random.default_rng(seed)
        self._ext = None
        if use_ext:
            from gammagl_tpu_torch import csrc
            csrc.get_lib()  # raises, with the compiler's output, on failure
            self._ext = csrc

    def sample_from_nodes(self, seed_nodes) -> SamplerOutput:
        if self._ext is not None:
            return self._sample_ext(seed_nodes)
        return self._sample_np(seed_nodes)

    def _sample_ext(self, seed_nodes) -> SamplerOutput:
        seed_nodes = np.asarray(seed_nodes, dtype=np.int64)
        nodes, rows, cols, edges, hop_nodes, hop_edges = \
            self._ext.neighbor_sample_c(
                self.colptr, self.row, self.edge_perm, seed_nodes,
                self.num_neighbors, self.replace,
                int(self.rng.integers(0, 2 ** 63)))
        return SamplerOutput(node=nodes, row=rows, col=cols, edge=edges,
                             batch_size=len(seed_nodes),
                             num_sampled_nodes=hop_nodes,
                             num_sampled_edges=hop_edges)

    def sample_from_nodes_many(self, seed_batches):
        """Sample several independent seed batches in one call, on the C++
        sampler's OpenMP threads; the numpy route samples them in turn."""
        if self._ext is None:
            return [self.sample_from_nodes(b) for b in seed_batches]
        outs = self._ext.neighbor_sample_many_c(
            self.colptr, self.row, self.edge_perm, seed_batches,
            self.num_neighbors, self.replace,
            int(self.rng.integers(0, 2 ** 63)))
        return [SamplerOutput(node=n, row=r, col=c, edge=e,
                              batch_size=len(seed_batches[i]),
                              num_sampled_nodes=hn, num_sampled_edges=he)
                for i, (n, r, c, e, hn, he) in enumerate(outs)]

    def _sample_np(self, seed_nodes) -> SamplerOutput:
        seed_nodes = np.asarray(seed_nodes, dtype=np.int64)
        sampled = list(seed_nodes)
        local = {int(n): i for i, n in enumerate(seed_nodes)}
        rows, cols, eids = [], [], []
        frontier = seed_nodes
        n_nodes = [len(seed_nodes)]
        n_edges = []
        for fanout in self.num_neighbors:
            next_frontier = []
            hop_edges = 0
            for dst in frontier:
                lo, hi = self.colptr[dst], self.colptr[dst + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                if fanout < 0 or deg <= fanout and not self.replace:
                    take = np.arange(lo, hi)
                elif self.replace:
                    take = lo + self.rng.integers(0, deg, fanout)
                else:
                    take = lo + self.rng.choice(deg, size=min(fanout, deg),
                                                replace=False)
                for e in take:
                    s = int(self.row[e])
                    if s not in local:
                        local[s] = len(sampled)
                        sampled.append(s)
                        next_frontier.append(s)
                    rows.append(local[s])
                    cols.append(local[int(dst)])
                    eids.append(int(self.edge_perm[e]))
                    hop_edges += 1
            n_nodes.append(len(next_frontier))
            n_edges.append(hop_edges)
            frontier = np.asarray(next_frontier, dtype=np.int64)
        return SamplerOutput(
            node=np.asarray(sampled, dtype=np.int64),
            row=np.asarray(rows, dtype=np.int64),
            col=np.asarray(cols, dtype=np.int64),
            edge=np.asarray(eids, dtype=np.int64),
            batch_size=len(seed_nodes),
            num_sampled_nodes=n_nodes,
            num_sampled_edges=n_edges,
        )


def sample_neighbors_padded(sampler: NeighborSampler, seed_nodes,
                            node_budget: int, edge_budget: int):
    """Sample, then pad to (node_budget, edge_budget).

    Returns a dict of numpy arrays: n_id (pad = num_nodes), edge_index
    local (pad dst = node_budget, dropped by the sums), e_id (pad -1),
    node_mask, edge_mask, and batch_size.
    """
    out = sampler.sample_from_nodes(seed_nodes)
    ns, es = len(out.node), len(out.row)
    if ns > node_budget or es > edge_budget:
        raise ValueError(
            f"budget too small: sampled ({ns}, {es}) vs budget "
            f"({node_budget}, {edge_budget})")
    n_id = np.full(node_budget, sampler.num_nodes, dtype=np.int64)
    n_id[:ns] = out.node
    ei = np.full((2, edge_budget), node_budget, dtype=np.int64)
    ei[0, :es] = out.row
    ei[1, :es] = out.col
    e_id = np.full(edge_budget, -1, dtype=np.int64)
    e_id[:es] = out.edge
    return {
        "n_id": n_id,
        "edge_index": ei,
        "e_id": e_id,
        "node_mask": np.arange(node_budget) < ns,
        "edge_mask": np.arange(edge_budget) < es,
        "batch_size": out.batch_size,
    }
