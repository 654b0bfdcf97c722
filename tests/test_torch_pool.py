"""The port's dense conversions (`utils/to_dense.py`) and pooling
(`layers/pool/`: the global readouts, sort pooling and MinCut) against
the JAX package, on numpy inputs from a seed.

Sums and means are held at 1e-5 of max |out| (float32, the sum order of
a scatter is not fixed); the max, min, sort and dense conversions are
exact (each output is one input value or a count). Gradients against
jax.grad at 1e-5 of max |grad|.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.layers import pool as jpool
from gammagl_tpu.utils.to_dense import to_dense_adj as jax_to_dense_adj
from gammagl_tpu.utils.to_dense import to_dense_batch as jax_to_dense_batch

from gammagl_tpu_torch.layers import pool
from gammagl_tpu_torch.utils import to_dense_adj, to_dense_batch


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _batch(sizes):
    return np.repeat(np.arange(len(sizes)), sizes)


def _inputs(sizes=(5, 1, 7, 3), F=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(sum(sizes), F)).astype(np.float32)
    return x, _batch(sizes)


@pytest.mark.parametrize("attr", [None, "scalar", "vector"])
@pytest.mark.parametrize("batched", [False, True])
def test_to_dense_adj_matches_jax(batched, attr):
    """Repeated edges add up; with a batch vector each graph's block sits
    at its own node ids, in (B, N_max, N_max[, F])."""
    rng = np.random.default_rng(1)
    sizes = (4, 6, 3)
    ptr = np.concatenate([[0], np.cumsum(sizes)])
    ei = np.concatenate([np.stack([rng.integers(a, b, 9),
                                   rng.integers(a, b, 9)])
                         for a, b in zip(ptr, ptr[1:])], 1)
    ei = np.concatenate([ei, ei[:, :3]], 1)  # repeated edges
    e = ei.shape[1]
    ea = {None: None,
          "scalar": rng.random(e).astype(np.float32),
          "vector": rng.random((e, 2)).astype(np.float32)}[attr]
    batch = _batch(sizes) if batched else None
    want = jax_to_dense_adj(jnp.asarray(ei),
                            None if batch is None else jnp.asarray(batch),
                            None if ea is None else jnp.asarray(ea))
    got = to_dense_adj(torch.tensor(ei),
                       None if batch is None else torch.tensor(batch),
                       None if ea is None else torch.tensor(ea))
    _close(got, want, 1e-6)


def test_to_dense_adj_sizes_given():
    ei = np.array([[0, 1, 3], [1, 2, 3]])
    batch = np.array([0, 0, 1, 1])
    for kw in ({"max_num_nodes": 5}, {"max_num_nodes": 3,
                                      "batch_size": 3}):
        want = jax_to_dense_adj(jnp.asarray(ei), jnp.asarray(batch), **kw)
        got = to_dense_adj(torch.tensor(ei), torch.tensor(batch), **kw)
        _close(got, want, 0)
    want = jax_to_dense_adj(jnp.asarray(ei), max_num_nodes=6)
    _close(to_dense_adj(torch.tensor(ei), max_num_nodes=6), want, 0)


@pytest.mark.parametrize("kw", [{}, {"fill_value": -1.5},
                                {"max_num_nodes": 9, "batch_size": 6},
                                {"max_num_nodes": 4}])
def test_to_dense_batch_matches_jax(kw):
    """Padded rows and the mask, bit for bit; a node past max_num_nodes
    in its graph is dropped, as the JAX scatter drops it."""
    x, batch = _inputs()
    out, mask = jax_to_dense_batch(jnp.asarray(x), jnp.asarray(batch), **kw)
    got, got_mask = to_dense_batch(torch.tensor(x), torch.tensor(batch),
                                   **kw)
    _close(got, out, 0)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    whole, whole_mask = to_dense_batch(torch.tensor(x))
    assert whole.shape == (1,) + x.shape and bool(whole_mask.all())


POOLS = ["global_sum_pool", "global_add_pool", "global_mean_pool",
         "global_max_pool", "global_min_pool"]


@pytest.mark.parametrize("how", ["whole", "batch", "batch_empty_graph"])
@pytest.mark.parametrize("name", POOLS)
def test_global_pool_matches_jax(name, how):
    """batch=None reduces every row into (1, F); a batch vector into one
    row a graph; a graph with no node (num_graphs past the last id)
    gives 0. Forward and the gradient of sum(out * g) in x."""
    x, batch = _inputs()
    num_graphs = None
    if how == "whole":
        batch = None
    elif how == "batch_empty_graph":
        num_graphs = 6
    jb = None if batch is None else jnp.asarray(batch)
    tb = None if batch is None else torch.tensor(batch)

    def jfn(jx):
        return getattr(jpool, name)(jx, jb, num_graphs)

    want = jfn(jnp.asarray(x))
    g = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    jdx = jax.grad(lambda jx: (jfn(jx) * jnp.asarray(g)).sum())(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = getattr(pool, name)(tx, tb, num_graphs)
    exact = name in ("global_max_pool", "global_min_pool")
    _close(got, want, 0 if exact else 1e-5)
    (got * torch.tensor(g)).sum().backward()
    _close(tx.grad, jdx, 1e-5)


@pytest.mark.parametrize("k", [1, 3, 7, 10])
@pytest.mark.parametrize("how", ["whole", "batch"])
def test_global_sort_pool_matches_jax(how, k):
    """Each graph's rows sorted by the last channel, largest first, ties
    in node order; k past a graph's size pads with zeros (the JAX -inf
    fill made 0); forward bit for bit, gradients of sum(out * g)."""
    x, batch = _inputs(sizes=(5, 1, 7, 3, 2))
    x[3, -1] = x[1, -1]  # a tie inside graph 0
    if how == "whole":
        batch = None
    jb = None if batch is None else jnp.asarray(batch)
    tb = None if batch is None else torch.tensor(batch)

    def jfn(jx):
        return jpool.global_sort_pool(jx, jb, k)

    want = jfn(jnp.asarray(x))
    g = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)
    jdx = jax.grad(lambda jx: (jfn(jx) * jnp.asarray(g)).sum())(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    got = pool.global_sort_pool(tx, tb, k)
    _close(got, want, 0)
    (got * torch.tensor(g)).sum().backward()
    _close(tx.grad, jdx, 0)


@pytest.mark.parametrize("temp", [1.0, 0.5])
def test_mincut_pool_matches_jax(temp):
    """The dense pool's four outputs and the sparse losses (weighted and
    not) against JAX, with the gradients of the losses in s; the sparse
    losses equal the dense ones on the same graph."""
    rng = np.random.default_rng(4)
    n, F, k = 12, 5, 3
    x = rng.normal(size=(n, F)).astype(np.float32)
    s = rng.normal(size=(n, k)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, 40), rng.integers(0, n, 40)])
    w = rng.random(40).astype(np.float32)
    adj = np.zeros((n, n), np.float32)
    np.add.at(adj, (ei[0], ei[1]), w)
    want = jpool.dense_mincut_pool(jnp.asarray(x), jnp.asarray(adj),
                                   jnp.asarray(s), temp=temp)
    ts = torch.tensor(s, requires_grad=True)
    got = pool.dense_mincut_pool(torch.tensor(x), torch.tensor(adj), ts,
                                 temp=temp)
    for a, b in zip(got, want):
        _close(a, b)
    (got[2] + got[3]).backward()
    jds = jax.grad(lambda js: sum(jpool.dense_mincut_pool(
        jnp.asarray(x), jnp.asarray(adj), js, temp=temp)[2:]))(
        jnp.asarray(s))
    _close(ts.grad, jds)
    for weight in (None, w):
        jw = None if weight is None else jnp.asarray(weight)
        tw = None if weight is None else torch.tensor(weight)
        want = jpool.sparse_mincut_losses(jnp.asarray(s), jnp.asarray(ei),
                                          n, jw, temp=temp)
        ts = torch.tensor(s, requires_grad=True)
        got = pool.sparse_mincut_losses(ts, torch.tensor(ei), n, tw,
                                        temp=temp)
        for a, b in zip(got, want):
            _close(a, b)
        sum(got).backward()
        jds = jax.grad(lambda js: sum(jpool.sparse_mincut_losses(
            js, jnp.asarray(ei), n, jw, temp=temp)))(jnp.asarray(s))
        _close(ts.grad, jds)
    dense = pool.dense_mincut_pool(torch.tensor(x), torch.tensor(adj),
                                   torch.tensor(s), temp=temp)
    sparse = pool.sparse_mincut_losses(torch.tensor(s), torch.tensor(ei), n,
                                       torch.tensor(w), temp=temp)
    for a, b in zip(sparse, dense[2:]):
        _close(a, b.detach().numpy())
