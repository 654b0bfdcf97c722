"""The port's loaders (`gammagl_tpu_torch/loader/`, `utils/subgraph.py`,
`serve.MicroBatcher`) against the JAX package's.

Each loader is built on the same graph with the same seed in both
packages and compared batch by batch, bitwise: the samples are host
numpy (or the same C++ sampler), so nothing may differ. The feature
cache, the prefetcher and the micro-batcher run on the CPU here
(``device="cpu"``); `tests/test_torch_cuda.py` runs them on the card.
"""

import threading
import time

import numpy as np
import pytest
import torch

from gammagl_tpu import loader as jl
from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.data import HeteroGraph as JaxHeteroGraph
from gammagl_tpu.utils import k_hop_subgraph as jax_k_hop
from gammagl_tpu.utils import subgraph as jax_subgraph
from gammagl_tpu_torch import loader as tl
from gammagl_tpu_torch.data import Graph, HeteroGraph
from gammagl_tpu_torch.serve import MicroBatcher
from gammagl_tpu_torch.utils import k_hop_subgraph, subgraph
from tests.test_torch_sampler import pin_jax_sampler_lib

N, E, F = 240, 1200, 6


@pytest.fixture(scope="module", autouse=True)
def jax_sampler_lib(tmp_path_factory):
    """The JAX package's sampler, built for this module, so its loaders
    never fall to their numpy routes (ROADMAP C30,
    `tests/test_torch_sampler.py`)."""
    mp = pytest.MonkeyPatch()
    yield pin_jax_sampler_lib(tmp_path_factory.mktemp("jax_sampler"), mp)
    mp.undo()


def _arrays(n=N, e=E, seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e),
                   rng.integers(0, max(n - 20, n // 2), e)])
    return {"x": rng.normal(size=(n, F)).astype(np.float32),
            "edge_index": ei, "y": rng.integers(0, 3, n),
            "edge_attr": rng.normal(size=(e, 2)).astype(np.float32),
            "train_mask": rng.random(n) < 0.5}


def _graphs(**arrays):
    """The same arrays as a port Graph and a JAX Graph."""
    return Graph(**arrays), JaxGraph(**arrays)


def _same(a, b, path="batch"):
    """Batches of either package, bitwise: Graphs field by field, tuples,
    lists and dicts entry by entry, arrays by value and dtype."""
    if isinstance(a, Graph):
        assert sorted(a.keys()) == sorted(b.keys()), path
        assert a.num_nodes == b.num_nodes, path
        for k in a.keys():
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), path


def _same_loaders(port, jax_loader, epochs=1):
    n = 0
    for _ in range(epochs):
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == len(port) == len(jax_loader)
        _same(got, want)
        n += len(got)
    return n


@pytest.mark.parametrize("form", ["one-call", "chunks", "legacy"])
def test_neighbor_sampler_loader_is_jax(form):
    d = _arrays()
    kw = dict(node_idx=d["train_mask"], sample_lists=[4, 3], batch_size=16,
              num_nodes=N, shuffle=True, seed=3,
              presample_chunks=3 if form == "chunks" else 1,
              use_ext=form != "legacy")
    port = tl.NeighborSamplerLoader(d["edge_index"], **kw)
    jax_loader = jl.NeighborSamplerLoader(d["edge_index"], **kw)
    assert (port._legacy is None) == (form != "legacy")
    assert _same_loaders(port, jax_loader, epochs=2) > 8
    bs, n_id, adjs = port.sample(np.arange(5))
    # blocks are outermost first; the last one's destinations are seeds
    assert adjs[-1].size[1] == 5 and adjs[0].size[0] == len(n_id)
    _same((bs, n_id, adjs), jax_loader.sample(np.arange(5)))
    assert tl.NeighborSampler is tl.NeighborSamplerLoader
    assert tl.RandomWalk is tl.RandomWalkLoader


def test_epoch_cache_is_jax():
    """Fresh, replayed (reshuffled), fresh again; `.sample` reaches the
    loader."""
    d = _arrays()
    kw = dict(sample_lists=[3, 2], batch_size=32, num_nodes=N, shuffle=True,
              seed=1)
    port = tl.EpochCache(tl.NeighborSamplerLoader(d["edge_index"], **kw),
                         resample_every=2, seed=4)
    jax_cache = jl.EpochCache(jl.NeighborSamplerLoader(d["edge_index"],
                                                       **kw),
                              resample_every=2, seed=4)
    epochs = [list(port) for _ in range(3)]
    _same(epochs, [list(jax_cache) for _ in range(3)])
    assert all(any(a is b for b in epochs[0]) for a in epochs[1])
    assert not any(a is b for b in epochs[0] for a in epochs[2])
    _same(port.sample(np.arange(4)), jax_cache.sample(np.arange(4)))
    port.invalidate()
    assert port._cache is None and len(port) == len(port.loader)
    with pytest.raises(ValueError):
        tl.EpochCache(port.loader, resample_every=0)


@pytest.mark.parametrize("pad", [False, True])
def test_dataloader_and_collater_are_jax(pad):
    graphs = []
    for i in range(7):
        a = _arrays(12 + i, 30 + 2 * i, seed=i)
        del a["train_mask"]
        graphs.append(a)
    port = tl.DataLoader([Graph(**a) for a in graphs], batch_size=3,
                         shuffle=True, seed=2, pad=pad)
    jax_loader = jl.DataLoader([JaxGraph(**a) for a in graphs],
                               batch_size=3, shuffle=True, seed=2, pad=pad)
    _same_loaders(port, jax_loader, epochs=2)
    assert len(tl.DataLoader(graphs, batch_size=3, drop_last=True)) == 2
    collate = tl.Collater(pad=pad)
    _same(collate([Graph(**a) for a in graphs[:2]]),
          jl.Collater(pad=pad)([JaxGraph(**a) for a in graphs[:2]]))


@pytest.mark.parametrize("chunks", [1, 2])
def test_node_neighbor_loader_is_jax(chunks):
    port_g, jax_g = _graphs(**_arrays())
    kw = dict(input_nodes=np.asarray(port_g.train_mask), batch_size=20,
              shuffle=True, seed=6, presample_chunks=chunks, drop_last=True)
    port = tl.NodeNeighborLoader(port_g, [4, 2], **kw)
    jax_loader = jl.NodeNeighborLoader(jax_g, [4, 2], **kw)
    assert _same_loaders(port, jax_loader) > 3
    sub = next(iter(port))
    assert sub.x.shape == (sub.num_nodes, F)
    assert sub.edge_attr.shape == (sub.edge_index.shape[1], 2)


def test_link_neighbor_loader_is_jax():
    port_g, jax_g = _graphs(**_arrays())
    kw = dict(neg_sampling_ratio=1.0, batch_size=64, shuffle=True, seed=8)
    port = tl.LinkNeighborLoader(port_g, [3, 2], **kw)
    jax_loader = jl.LinkNeighborLoader(jax_g, [3, 2], **kw)
    assert _same_loaders(port, jax_loader) == -(-E // 64)


@pytest.mark.parametrize("kind", ["node", "walk"])
def test_graph_saint_is_jax(kind):
    port_g, jax_g = _graphs(**_arrays())
    if kind == "node":
        port = tl.GraphSAINTNodeSampler(port_g, 50, num_steps=3,
                                        sample_coverage=4, seed=9)
        jax_s = jl.GraphSAINTNodeSampler(jax_g, 50, num_steps=3,
                                         sample_coverage=4, seed=9)
    else:
        port = tl.GraphSAINTRandomWalkSampler(port_g, 20, walk_length=3,
                                              num_steps=3, sample_coverage=4,
                                              seed=9)
        # JAX's constructor raises with sample_coverage > 0 (it builds the
        # walks' CSR after the norms, ROADMAP C25): build it without, then
        # draw the norms as its constructor would, first from its rng
        with pytest.raises(AttributeError, match="rowptr"):
            jl.GraphSAINTRandomWalkSampler(jax_g, 20, walk_length=3,
                                           sample_coverage=4, seed=9)
        jax_s = jl.GraphSAINTRandomWalkSampler(jax_g, 20, walk_length=3,
                                               num_steps=3, seed=9)
        jax_s.sample_coverage = 4
        jax_s.node_norm, jax_s.edge_norm = jax_s._compute_norm()
    _same((port.node_norm, port.edge_norm), (jax_s.node_norm,
                                            jax_s.edge_norm))
    assert _same_loaders(port, jax_s) == 3
    plain = tl.GraphSAINTNodeSampler(port_g, 50, seed=9)
    assert not hasattr(plain, "node_norm") and "node_norm" not in next(
        iter(plain))


@pytest.mark.parametrize("p, q", [(1.0, 1.0), (0.5, 2.0)])
def test_random_walk_loader_is_jax(p, q):
    d = _arrays()
    kw = dict(batch_size=50, walk_length=5, num_negatives=2, p=p, q=q,
              seed=12)
    port = tl.RandomWalkLoader(d["edge_index"], N, **kw)
    jax_loader = jl.RandomWalkLoader(d["edge_index"], N, **kw)
    assert _same_loaders(port, jax_loader) == -(-N // 50)
    _same(tl.random_walk(d["edge_index"], N, np.arange(0, N, 9), 4, p, q,
                         np.random.default_rng(1)),
          jl.random_walk(d["edge_index"], N, np.arange(0, N, 9), 4, p, q,
                         np.random.default_rng(1)))


def _hetero(cls, with_author_x):
    rng = np.random.default_rng(2)
    hg = cls()
    hg["paper"].x = rng.normal(size=(60, 4)).astype(np.float32)
    hg["paper"].y = rng.integers(0, 3, 60)
    if with_author_x:
        hg["author"].x = rng.normal(size=(40, 3)).astype(np.float32)
    hg[("author", "writes", "paper")].edge_index = np.stack(
        [rng.integers(0, 40, 200), rng.integers(0, 60, 200)])
    hg[("paper", "cites", "paper")].edge_index = np.stack(
        [rng.integers(0, 60, 150), rng.integers(0, 60, 150)])
    return hg


def _same_hetero(a, b):
    assert a.node_types == b.node_types and a.edge_types == b.edge_types
    for t in a.node_types + a.edge_types:
        assert sorted(a[t].keys()) == sorted(b[t].keys()), t
        for k in a[t].keys():
            _same(a[t][k], b[t][k], f"{t}.{k}")


@pytest.mark.parametrize("author_x", [True, False])
def test_hetero_neighbor_loader_is_jax(author_x):
    """The C++ route through the loader, a featureless type too (its size
    from the edges)."""
    kw = dict(input_nodes=("paper", np.arange(0, 60, 2)), batch_size=8,
              shuffle=True, seed=4)
    port = tl.HeteroNeighborLoader(_hetero(HeteroGraph, author_x), [3, 2],
                                   **kw)
    jax_loader = jl.HeteroNeighborLoader(_hetero(JaxHeteroGraph, author_x),
                                         [3, 2], **kw)
    got, want = list(port), list(jax_loader)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _same_hetero(a, b)
    assert len(got[0]["author"].n_id) > 0


@pytest.mark.parametrize("use_ext", [True, False])
def test_hetero_neighbor_sampler_routes_are_jax(use_ext):
    port = tl.HeteroNeighborSampler(_hetero(HeteroGraph, False),
                                    {("author", "writes", "paper"): [4, 2],
                                     ("paper", "cites", "paper"): [-1]},
                                    seed=1, use_ext=use_ext)
    jax_s = jl.HeteroNeighborSampler(_hetero(JaxHeteroGraph, False),
                                     {("author", "writes", "paper"): [4, 2],
                                      ("paper", "cites", "paper"): [-1]},
                                     seed=1, use_ext=use_ext)
    for seeds in (np.arange(5), np.array([7, 30, 59])):
        _same(port.sample_from_nodes({"paper": seeds}),
              jax_s.sample_from_nodes({"paper": seeds}))


@pytest.mark.parametrize("relabel", [False, True])
def test_subgraph_and_k_hop_are_jax(relabel):
    d = _arrays()
    subset = np.arange(0, N, 3)
    _same(subgraph(subset, d["edge_index"], d["edge_attr"], relabel, N),
          jax_subgraph(subset, d["edge_index"], d["edge_attr"], relabel, N))
    mask = np.zeros(N, bool)
    mask[subset] = True
    _same(subgraph(mask, d["edge_index"], relabel_nodes=relabel),
          jax_subgraph(mask, d["edge_index"], relabel_nodes=relabel))
    for flow in ("source_to_target", "target_to_source"):
        _same(k_hop_subgraph([3, 7], 2, d["edge_index"], relabel, N, flow),
              jax_k_hop([3, 7], 2, d["edge_index"], relabel, N, flow))


@pytest.mark.parametrize("budget", ["rows", "bytes", "score", "disabled"])
def test_device_feature_cache_on_the_cpu(budget):
    """Values bitwise x[idx], JAX's hit and miss counts and hit rate."""
    x = _arrays()["x"]
    score = np.random.default_rng(5).random(N)
    kw = {"rows": dict(budget_rows=100), "bytes": dict(budget_bytes="1K"),
          "score": dict(budget_rows=60, score=score),
          "disabled": dict(budget_rows=0)}[budget]
    port = tl.DeviceFeatureCache(x, device="cpu", **kw)
    jax_cache = jl.DeviceFeatureCache(x, **kw)
    assert port.budget_rows == jax_cache.budget_rows
    assert port.budget_rows == {"rows": 100, "bytes": 1024 // (F * 4),
                                "score": 60, "disabled": 0}[budget]
    np.testing.assert_array_equal(port.hot_ids, jax_cache.hot_ids)
    rng = np.random.default_rng(6)
    for _ in range(3):
        idx = rng.integers(0, N, 50)
        got = port[idx]
        assert got.device.type == "cpu" and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), x[idx])
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax_cache[idx]))
    assert (port.hits, port.misses) == (jax_cache.hits, jax_cache.misses)
    assert port.hit_rate == jax_cache.hit_rate
    assert port[np.zeros(0, np.int64)].shape == (0, F)


def test_device_feature_cache_asks_for_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.DeviceFeatureCache(np.zeros((4, 2), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.PrefetchLoader([1, 2])


def test_prefetch_loader_keeps_order_and_moves_batches():
    port_g, _ = _graphs(**_arrays())
    batches = list(tl.NodeNeighborLoader(port_g, [3, 2], batch_size=40,
                                         seed=1))
    got = list(tl.PrefetchLoader(batches, size=2, device="cpu"))
    assert len(got) == len(batches) == 6
    for a, b in zip(got, batches):
        assert isinstance(a.x, torch.Tensor) and isinstance(a.n_id,
                                                            torch.Tensor)
        assert a.batch_size == b.batch_size
        _same(a, b)
    items = [(np.arange(i, i + 3), {"y": np.full(2, i)}, i, "tag")
             for i in range(5)]
    out = list(tl.prefetch_to_device(iter(items), size=1, device="cpu"))
    for i, (arr, d, n, tag) in enumerate(out):
        assert torch.equal(arr, torch.arange(i, i + 3))
        assert torch.equal(d["y"], torch.full((2,), i))
        assert (n, tag) == (i, "tag")


def test_pipeline_raises_the_workers_error_after_its_items():
    def items():
        yield 1
        yield 2
        raise KeyError("worker failed")

    got = []
    with pytest.raises(KeyError, match="worker failed"):
        for item in tl.pipeline(items(), size=1, transform=lambda v: v * 10):
            got.append(item)
    assert got == [10, 20]
    with pytest.raises(KeyError):
        list(tl.PrefetchLoader(_Failing(), device="cpu"))


class _Failing:
    def __len__(self):
        return 2

    def __iter__(self):
        yield np.zeros(2)
        raise KeyError("loader failed")


def test_micro_batcher_batches_and_splits():
    """tests/test_serve.py's checks of JAX's, and tuple items."""
    seen = []

    def run(batch, n_valid):
        seen.append((int(batch[0].shape[0]), n_valid))
        return batch[0] * 2.0, torch.from_numpy(batch[1]).sum(-1)

    with MicroBatcher(run, buckets=(4, 16), linger_ms=30.0) as mb:
        futs = [mb.submit((np.full((3,), float(i), np.float32),
                           np.arange(i, i + 2))) for i in range(10)]
        outs = [f.result(timeout=30) for f in futs]
    for i, (a, s) in enumerate(outs):
        np.testing.assert_allclose(a, 2.0 * i)
        assert a.shape == (3,) and int(s) == 2 * i + 1
    assert all(b in (4, 16) for b, _ in seen)
    assert sum(n for _, n in seen) == 10


def test_micro_batcher_pads_and_widens_bf16():
    def run(batch, n_valid):
        assert batch.shape == (8, 2) and not batch[n_valid:].any()
        return torch.from_numpy(batch).to(torch.bfloat16) + 0.5

    with MicroBatcher(run, buckets=(8,), linger_ms=1.0) as mb:
        out = mb.submit(np.array([1.0, 2.0], np.float32)).result(timeout=30)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [1.5, 2.5])
    with pytest.raises(ValueError):
        MicroBatcher(run, buckets=())


def test_micro_batcher_propagates_errors_to_every_waiter():
    release = threading.Event()

    def run(batch, n_valid):
        release.wait(5)
        raise RuntimeError("boom")

    with MicroBatcher(run, buckets=(2, 4), linger_ms=20.0) as mb:
        futs = [mb.submit(np.zeros((2,))) for _ in range(3)]
        time.sleep(0.05)
        release.set()
        for fut in futs:
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=30)
    assert not mb._worker.is_alive()
