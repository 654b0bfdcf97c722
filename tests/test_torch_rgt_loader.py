"""RGT's structure loaders in the port (`loader/rgt_loader.py`) against
the JAX package's, batch for batch and bitwise.

Both packages sample with the same C++ sampler source under the same
seed and build the tree, cycle and sequence buffers in host numpy, so
nothing may differ: every field of every batch, over two epochs (the
second replayed from the cache where the loader does not shuffle). The
JAX package's sampler is built for this module and pinned (ROADMAP C30,
`tests/test_torch_sampler.py`).
"""

import numpy as np
import pytest

from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.loader import rgt_loader as jr
from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.loader import (ExtractLinkLoader, ExtractNodeLoader,
                                      build_structure_batch)
from gammagl_tpu_torch.loader.rgt_loader import LRUCache
from tests.test_torch_loaders import _same, _same_loaders
from tests.test_torch_sampler import pin_jax_sampler_lib

N, E, F = 60, 200, 5


@pytest.fixture(scope="module", autouse=True)
def jax_sampler_lib(tmp_path_factory):
    """The JAX package's sampler, built for this module (C30)."""
    mp = pytest.MonkeyPatch()
    yield pin_jax_sampler_lib(tmp_path_factory.mktemp("jax_sampler"), mp)
    mp.undo()


def _arrays(seed=0):
    """A graph whose last 6 nodes have no edges, features and labels."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N - 6, (2, E))
    return {"x": rng.normal(size=(N, F)).astype(np.float32),
            "edge_index": ei, "y": rng.integers(0, 3, N),
            "train_mask": rng.random(N) < 0.6}


def _graphs(seed=0):
    d = _arrays(seed)
    return Graph(**d), JaxGraph(**d)


def _subgraphs():
    """Edge lists of sampled-subgraph size: a ring (cycles close), a
    star, a path, a random multigraph with self-loops, no edges."""
    rng = np.random.default_rng(5)
    ring = np.stack([np.arange(8), (np.arange(8) + 1) % 8])
    star = np.stack([np.zeros(7, np.int64), np.arange(1, 8)])
    path = np.stack([np.arange(9), np.arange(1, 10)])
    rand = rng.integers(0, 12, (2, 30))
    rand[:, :3] = 4  # self-loops
    return [(ring, 8), (star, 8), (path, 10), (rand, 12),
            (np.zeros((2, 0), np.int64), 5)]


@pytest.mark.parametrize("case", range(5))
@pytest.mark.parametrize("caps", [(32, 3, 4), (4, 3, 2), (2, 4, 6)])
def test_build_structure_batch_bitwise(case, caps):
    ei, n = _subgraphs()[case]
    for seeds in (1, 3, n):
        want = jr.build_structure_batch(ei, n, seeds, *caps)
        got = build_structure_batch(ei, n, seeds, *caps)
        _same(got, want)
        assert all(g.shape == (2, seeds * 2 * c) for g, c in zip(got, caps))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("fanout,batch,pad", [([4, 2], 4, None),
                                              ([3], 5, None),
                                              ([2, 2], 3, 200)])
def test_extract_node_loader_is_jax(shuffle, fanout, batch, pad):
    tg, jg = _graphs()
    kw = dict(num_neighbors=fanout, batch_size=batch, shuffle=shuffle,
              max_tree_edges=8, pad_num_nodes=pad, seed=3)
    port, ref = ExtractNodeLoader(tg, **kw), jr.ExtractNodeLoader(jg, **kw)
    assert _same_loaders(port, ref, epochs=2) == 2 * (N // batch)
    # without shuffling, the second epoch is the cache's: the same objects
    # (each pass samples anew all the same, so both loaders take two)
    if not shuffle:
        assert next(iter(port)) is next(iter(port))
        assert next(iter(ref)) is next(iter(ref))
        port.clear_cache()
        ref.clear_cache()
        _same(list(port)[:2], list(ref)[:2])


def test_extract_node_loader_input_nodes_and_caps():
    tg, jg = _graphs(1)
    mask = _arrays(1)["train_mask"]
    kw = dict(num_neighbors=[3, 3], input_nodes=mask, batch_size=6,
              shuffle=True, max_depth_cycle=4, sequence_length=3,
              max_tree_edges=5, seed=9)
    port, ref = ExtractNodeLoader(tg, **kw), jr.ExtractNodeLoader(jg, **kw)
    assert port.pad_num_nodes == ref.pad_num_nodes == 6 * 16
    assert _same_loaders(port, ref, epochs=2) == 2 * (mask.sum() // 6)


@pytest.mark.parametrize("shuffle", [False, True])
def test_extract_link_loader_is_jax(shuffle):
    """ROADMAP C37: JAX's ExtractLinkLoader hands ``seed`` to its sampler
    only, so a shuffled edge order comes from an unseeded generator; the
    port follows. The test seeds both loaders' order generators alike."""
    tg, jg = _graphs(2)
    label = np.random.default_rng(4).integers(0, N - 6, (2, 23))
    kw = dict(num_neighbors=[3, 2], edge_label_index=label, batch_size=5,
              shuffle=shuffle, max_tree_edges=6, seed=1)
    port, ref = ExtractLinkLoader(tg, **kw), jr.ExtractLinkLoader(jg, **kw)
    port.rng, ref.rng = (np.random.default_rng(7) for _ in range(2))
    assert _same_loaders(port, ref, epochs=2) == 2 * 5


def test_lru_cache_is_jax():
    got, want = LRUCache(2), jr.LRUCache(2)
    for op in (("put", 1, "a"), ("put", 2, "b"), ("get", 1), ("put", 3, "c"),
               ("get", 2), ("get", 1), ("get", 3), ("put", 4, "d"),
               ("get", 1)):
        a, b = (getattr(c, op[0])(*op[1:]) for c in (got, want))
        assert a == b
        assert list(got._d.items()) == list(want._d.items())
    assert (3 in got) == (3 in want)
    got.clear()
    assert 4 not in got
