"""The port's host sampler (`gammagl_tpu_torch.csrc`, `sampler/`) against
the JAX package's, bitwise.

Both packages build the same ``sampler.cpp`` (the port its own copy, into
``gammagl_tpu_torch/_build/``), so every binding gives JAX's outputs for
the same inputs and seeds; both `NeighborSampler` routes draw JAX's
samples. The port takes no numpy route unless asked (``use_ext=False``):
a failed build raises.

The JAX package's build of its library is not safe under concurrency: it
compiles onto its one library path with no temporary name, and a process
whose build fails keeps ``_lib = None`` for its life (ROADMAP C30). Under
xdist every worker collects `tests/csrc/`, which builds at collection, so
a worker can lose that race. The reference here therefore builds its own
copy (`pin_jax_sampler_lib`, the JAX package's command) into a temporary
directory and pins the JAX package to it for the module.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from gammagl_tpu import csrc as jcsrc
from gammagl_tpu.sampler import NeighborSampler as JaxSampler
from gammagl_tpu.sampler import sample_neighbors_padded as jax_padded
from gammagl_tpu_torch import csrc
from gammagl_tpu_torch.ops.sparse import ind2ptr_np
from gammagl_tpu_torch.sampler import NeighborSampler, sample_neighbors_padded

N, E = 300, 1500
MIX = 0x9E3779B97F4A7C15  # sampler.cpp's per-batch seed step


def pin_jax_sampler_lib(directory, monkeypatch):
    """Compile the JAX package's ``sampler.cpp`` with its own command into
    ``directory`` (a temporary name, then renamed into place), load it, and
    make the JAX package's `csrc` use it (``_lib``; ``_build_failed``
    cleared) through ``monkeypatch``. A failed compile raises with the
    compiler's message: the reference never falls back to numpy here."""
    path = os.path.join(str(directory), "_sampler.so")
    part = f"{path}.{os.getpid()}.part"
    res = subprocess.run(["g++", "-O3", "-std=c++17", "-fopenmp", "-shared",
                          "-fPIC", "-o", part, jcsrc._SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the JAX sampler failed:\n{res.stderr}")
    os.replace(part, path)
    lib = ctypes.CDLL(path)
    jcsrc._declare(lib)
    monkeypatch.setattr(jcsrc, "_lib", lib)
    monkeypatch.setattr(jcsrc, "_build_failed", False)
    return lib


@pytest.fixture(scope="module", autouse=True)
def jax_sampler_lib(tmp_path_factory):
    """The JAX package's sampler, built for this module (C30)."""
    mp = pytest.MonkeyPatch()
    yield pin_jax_sampler_lib(tmp_path_factory.mktemp("jax_sampler"), mp)
    mp.undo()


def test_reference_survives_a_lost_build_race(tmp_path, monkeypatch,
                                               jax_sampler_lib,
                                               tmp_path_factory):
    """ROADMAP C30. The module's reference is the fixture's library, and
    from the state of a worker that lost the JAX package's build race
    (``_lib = None``, ``_build_failed = True``: `get_lib` gives None) the
    fixture's build still gives a library that the comparisons run on."""
    base = str(tmp_path_factory.getbasetemp())
    assert jcsrc.get_lib() is jax_sampler_lib
    assert jax_sampler_lib._name.startswith(base)
    monkeypatch.setattr(jcsrc, "_lib", None)
    monkeypatch.setattr(jcsrc, "_build_failed", True)
    assert jcsrc.get_lib() is None and not jcsrc.available()
    lib = pin_jax_sampler_lib(tmp_path, monkeypatch)
    assert jcsrc.get_lib() is lib and lib._name.startswith(str(tmp_path))
    ind = np.sort(np.random.default_rng(2).integers(0, 40, 200))
    _same(csrc.ind2ptr_c(ind, 45), jcsrc.ind2ptr_c(ind, 45))


def _graph(n=N, e=E, seed=0):
    """Random directed edges into the first 4/5 of the nodes (the rest
    have no in-edges: isolated seeds), with some repeated edges."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n * 4 // 5, e)])
    return np.concatenate([ei, ei[:, :50]], axis=1)


def _csc(ei, n=N):
    order = np.argsort(ei[1], kind="stable")
    return ind2ptr_np(ei[1][order], n), ei[0][order], order


def _same(a, b):
    """Nested tuples / lists of arrays and ints, bitwise."""
    assert type(a) is type(b) or isinstance(a, np.ndarray)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


SEEDS = {
    "plain": np.arange(0, 300, 7),
    "duplicates": np.array([5, 5, 9, 5, 9, 17]),
    "isolated": np.array([250, 260, 299, 3]),
}
FANOUTS = {"2-3": [3, 2], "full-first": [-1, 2], "full": [-1], "5-4-2":
           [5, 4, 2]}


@pytest.mark.parametrize("replace", [False, True])
@pytest.mark.parametrize("fanouts", sorted(FANOUTS))
@pytest.mark.parametrize("seeds", sorted(SEEDS))
def test_neighbor_sample_c_is_jax(seeds, fanouts, replace):
    colptr, row, perm = _csc(_graph())
    args = (colptr, row, perm, SEEDS[seeds], FANOUTS[fanouts], replace,
            12345)
    _same(csrc.neighbor_sample_c(*args), jcsrc.neighbor_sample_c(*args))


def test_caps_bound_duplicate_seeds_of_a_full_first_hop():
    """A full neighbourhood at hop 0 with duplicate seeds: the hop-0
    frontier keeps the duplicates, so the edge bound adds dups x max
    degree (csrc/__init__.py's `_caps`) and the call does not overflow."""
    ei = np.stack([np.arange(40), np.zeros(40, np.int64)])  # 40 into node 0
    colptr, row, perm = _csc(ei, 50)
    seeds = np.array([0, 0, 0, 1])
    assert csrc._caps(seeds, [-1], colptr, 40) == jcsrc._caps(
        seeds, [-1], colptr, 40) == (54, 120)
    out = csrc.neighbor_sample_c(colptr, row, perm, seeds, [-1], False, 0)
    _same(out, jcsrc.neighbor_sample_c(colptr, row, perm, seeds, [-1],
                                       False, 0))
    assert len(out[1]) == 120


def test_neighbor_sample_c_without_edges():
    ei = np.zeros((2, 0), np.int64)
    colptr, row, perm = _csc(ei, 10)
    for fanouts in ([3, 2], [-1]):
        args = (colptr, row, perm, np.array([1, 4]), fanouts, False, 7)
        out = csrc.neighbor_sample_c(*args)
        _same(out, jcsrc.neighbor_sample_c(*args))
        assert len(out[1]) == 0 and list(out[0]) == [1, 4]


def test_ind2ptr_ptr2ind_c_are_jax():
    ind = np.sort(np.random.default_rng(1).integers(0, 40, 300))
    _same(csrc.ind2ptr_c(ind, 45), jcsrc.ind2ptr_c(ind, 45))
    ptr = csrc.ind2ptr_c(ind, 45)
    _same(csrc.ptr2ind_c(ptr), jcsrc.ptr2ind_c(ptr))
    np.testing.assert_array_equal(csrc.ptr2ind_c(ptr), ind)
    _same(csrc.ind2ptr_c(np.zeros(0), 3), jcsrc.ind2ptr_c(np.zeros(0), 3))


@pytest.mark.parametrize("walk_length", [1, 6])
def test_random_walk_c_is_jax(walk_length):
    ei = _graph()
    order = np.argsort(ei[0], kind="stable")
    rowptr, col = ind2ptr_np(ei[0][order], N), ei[1][order]
    starts = np.arange(0, N, 3)  # some without out-edges
    _same(csrc.random_walk_c(rowptr, col, starts, walk_length, 99),
          jcsrc.random_walk_c(rowptr, col, starts, walk_length, 99))


def test_saint_subgraph_c_is_jax():
    ei = _graph()
    order = np.argsort(ei[0], kind="stable")
    rowptr, col = ind2ptr_np(ei[0][order], N), ei[1][order]
    nodes = np.unique(np.random.default_rng(2).integers(0, N, 80))
    _same(csrc.saint_subgraph_c(rowptr, col, order, nodes),
          jcsrc.saint_subgraph_c(rowptr, col, order, nodes))


def test_hetero_neighbor_sample_c_is_jax():
    rng = np.random.default_rng(3)
    ets = [(rng.integers(0, 30, 90), rng.integers(0, 20, 90), 30, 20),
           (rng.integers(0, 20, 60), rng.integers(0, 30, 60), 20, 30),
           (rng.integers(0, 30, 0), rng.integers(0, 30, 0), 30, 30)]
    csc = []
    for src, dst, _, n_dst in ets:
        order = np.argsort(dst, kind="stable")
        csc.append((ind2ptr_np(dst[order], n_dst), src[order], order))
    fanouts = np.array([[3, 2, 1], [-1, 2, 2]])
    args = (csc, [0, 1, 0], [1, 0, 0], fanouts, [1, 2, 3, 4, 0],
            [1, 1, 1, 1, 0], 2, 77, 64, 256)
    got = csrc.hetero_neighbor_sample_c(*args)
    want = jcsrc.hetero_neighbor_sample_c(*args)
    # the buffers are filled up to each type's count, the rest unset
    (nodes, ncnt, *edge_bufs, ecnt) = got
    _same((ncnt, ecnt), (want[1], want[5]))
    for t, c in enumerate(ncnt):
        _same(nodes[t, :c], want[0][t, :c])
    for buf, wbuf in zip(edge_bufs, want[2:5]):
        for j, c in enumerate(ecnt):
            _same(buf[j, :c], wbuf[j, :c])
    assert ncnt.sum() > 5 and ecnt[:2].min() > 0 and ecnt[2] == 0


@pytest.mark.parametrize("use_ext", [True, False])
@pytest.mark.parametrize("replace", [False, True])
def test_neighbor_sampler_routes_are_jax(use_ext, replace):
    """Each route against the same route of JAX's, over several calls of
    one sampler (the seeds' stream advances alike)."""
    ei = _graph()
    port = NeighborSampler(ei, N, [4, 3], replace=replace, seed=5,
                           use_ext=use_ext)
    jax_s = JaxSampler(ei, N, [4, 3], replace=replace, seed=5,
                       use_ext=use_ext)
    assert (port._ext is None) == (jax_s._ext is None) == (not use_ext)
    for seeds in (np.arange(10), np.array([3, 3, 250]), np.arange(40, 90)):
        _same(tuple(port.sample_from_nodes(seeds)),
              tuple(jax_s.sample_from_nodes(seeds)))


def test_to_csc_is_numpys_stable_sort():
    from gammagl_tpu_torch.sampler.neighbor_sampler import _to_csc
    ei = _graph()
    _same(_to_csc(ei, N), _csc(ei))


def test_sample_from_nodes_many_is_jax_and_each_batch_alone():
    """A chunk in one call gives JAX's outputs, and batch b is
    `neighbor_sample_c` alone at the seed rng_seed + b * MIX: no batch
    depends on another, so the thread count cannot move a sample."""
    ei = _graph()
    chunk = [np.arange(0, 20), np.arange(20, 27), np.array([250, 3, 3])]
    port = NeighborSampler(ei, N, [4, 2], seed=11)
    jax_s = JaxSampler(ei, N, [4, 2], seed=11)
    got = port.sample_from_nodes_many(chunk)
    _same([tuple(o) for o in got],
          [tuple(o) for o in jax_s.sample_from_nodes_many(chunk)])
    base = int(np.random.default_rng(11).integers(0, 2 ** 63))
    for b, (seeds, out) in enumerate(zip(chunk, got)):
        alone = csrc.neighbor_sample_c(
            port.colptr, port.row, port.edge_perm, seeds, [4, 2], False,
            (base + b * MIX) % 2 ** 64)
        _same(tuple(out)[:4], alone[:4])
        assert out.num_sampled_nodes == alone[4]
        assert out.num_sampled_edges == alone[5]


def test_sample_neighbors_padded_is_jax():
    ei = _graph()
    port = NeighborSampler(ei, N, [3, 2], seed=1)
    jax_s = JaxSampler(ei, N, [3, 2], seed=1)
    got = sample_neighbors_padded(port, np.arange(8), 128, 96)
    want = jax_padded(jax_s, np.arange(8), 128, 96)
    assert sorted(got) == sorted(want)
    for k in got:
        _same(got[k], want[k])
    with pytest.raises(ValueError, match="budget too small"):
        sample_neighbors_padded(port, np.arange(8), 8, 96)


def test_library_lands_in_build_under_its_hash_name():
    path = csrc.lib_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "gammagl_tpu_torch"
    assert path.name.startswith("libgammagl_sampler_")
    assert csrc.available() and path.is_file()
    assert csrc.get_lib()._name == str(path)


def test_failed_build_raises_and_takes_no_numpy_route(tmp_path,
                                                      monkeypatch):
    """A build pointed at a missing compiler raises from `get_lib` and from
    a sampler built with use_ext=True; `available` says False; only
    use_ext=False samples."""
    from gammagl_tpu_torch.loader import (HeteroNeighborLoader,
                                          NeighborSamplerLoader)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(csrc, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        csrc.get_lib()
    assert not csrc.available()
    ei = _graph()
    with pytest.raises(RuntimeError, match="no-such-g"):
        NeighborSampler(ei, N, [3], seed=0)
    with pytest.raises(RuntimeError, match="no-such-g"):
        NeighborSamplerLoader(ei, num_nodes=N, sample_lists=[3])
    from gammagl_tpu_torch.data import HeteroGraph
    hg = HeteroGraph()
    hg["a"].x = np.zeros((N, 2), np.float32)
    hg[("a", "to", "a")].edge_index = ei
    with pytest.raises(RuntimeError, match="no-such-g"):
        HeteroNeighborLoader(hg, [2], ("a", np.arange(4)))
    out = NeighborSampler(ei, N, [3], seed=0, use_ext=False
                          ).sample_from_nodes([1, 2])
    assert len(out.row) > 0
    assert not list((tmp_path / "_build").glob("*.so"))


def test_failed_compile_quotes_the_compiler(tmp_path, monkeypatch):
    """A compiler that runs and fails: its exit code and stderr are in the
    error, and no library or temporary file is left."""
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'sampler.cpp:1: error: broken' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(csrc, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="(?s)exit code 3.*broken"):
        csrc.get_lib()
    assert not list((tmp_path / "_build").iterdir())
