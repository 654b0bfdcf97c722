"""The host sampler: ``sampler.cpp`` built with g++ at first use and bound
by ctypes (counterpart of `gammagl_tpu/csrc/__init__.py`).

``sampler.cpp`` is the JAX package's source, copied unchanged, so both
packages draw the same samples from the same seed. The first call to
`get_lib` compiles it (``g++ -O3 -std=c++17 -fopenmp -shared -fPIC``)
into ``gammagl_tpu_torch/_build/``, naming the library by a hash of the
source and the flags, as `ops.cuda._build` names the kernel library: an
edit rebuilds it, an unchanged tree reuses it. A build writes a temporary
file beside the library and renames it into place, so processes building
at once each see the whole library or none.

There is no silent fallback: when the build fails, `get_lib` raises with
the compiler's output, and so does every sampler built with
``use_ext=True``. The numpy routes of the samplers run only when asked
for (``use_ext=False``). `available` says whether the build succeeds.

The C++ sources contain no CUDA: sampling is host work, and its outputs
are padded and moved to the card by the loaders.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "available", "neighbor_sample_c",
           "neighbor_sample_many_c", "random_walk_c",
           "saint_subgraph_c", "ind2ptr_c", "ptr2ind_c",
           "hetero_neighbor_sample_c"]

SRC = Path(__file__).resolve().with_name("sampler.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the compiler; tests point it elsewhere to see a failed build raise
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC")

_I64 = ctypes.POINTER(ctypes.c_int64)
_lock = threading.Lock()


def lib_path():
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libgammagl_sampler_{h.hexdigest()[:16]}.so"


def _build(path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}"
                         ".tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
    except OSError as e:  # no such compiler
        raise RuntimeError(f"building {SRC.name} with {CXX!r} failed: "
                           f"{e}") from e
    try:
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {SRC.name} failed with exit code "
                f"{proc.returncode}:\n{' '.join(proc.args)}\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, path)  # atomic: a concurrent build sees all/none
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib):
    lib.ind2ptr.restype = None
    lib.ind2ptr.argtypes = [_I64, ctypes.c_int64, ctypes.c_int64, _I64]
    lib.ptr2ind.restype = None
    lib.ptr2ind.argtypes = [_I64, ctypes.c_int64, _I64]
    lib.neighbor_sample.restype = ctypes.c_int
    lib.neighbor_sample.argtypes = [
        _I64, _I64, _I64, _I64, ctypes.c_int64, _I64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64]
    lib.neighbor_sample_many.restype = None
    lib.neighbor_sample_many.argtypes = [
        _I64, _I64, _I64, _I64, _I64, ctypes.c_int64, _I64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _I64]
    lib.random_walk.restype = None
    lib.random_walk.argtypes = [_I64, _I64, _I64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_uint64, _I64]
    lib.saint_subgraph.restype = ctypes.c_int64
    lib.saint_subgraph.argtypes = [_I64, _I64, _I64, _I64, ctypes.c_int64,
                                   _I64, _I64, _I64, ctypes.c_int64]
    lib.hetero_neighbor_sample.restype = ctypes.c_int
    lib.hetero_neighbor_sample.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I64, _I64, _I64, _I64, _I64,
        _I64, _I64, _I64, ctypes.c_int64, _I64, _I64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
        _I64, _I64, _I64, _I64, _I64, _I64]


@functools.lru_cache(maxsize=None)
def _load(path):
    with _lock:
        if not path.is_file():
            _build(path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


def get_lib():
    """The sampler library (a ``ctypes.CDLL``), built first when no build
    of the current source exists. Raises RuntimeError, with the
    compiler's output, when the build fails."""
    return _load(lib_path())


def available():
    """Whether the library builds and loads."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _p(arr):
    return arr.ctypes.data_as(_I64)


def _as_i64(x):
    return np.ascontiguousarray(np.asarray(x), dtype=np.int64)


def ind2ptr_c(ind, n):
    """Sorted indices -> a pointer array of length n + 1 (int64)."""
    lib = get_lib()
    ind = _as_i64(ind)
    out = np.empty(n + 1, np.int64)
    lib.ind2ptr(_p(ind), len(ind), n, _p(out))
    return out


def ptr2ind_c(ptr):
    """A pointer array -> the index of each entry (int64)."""
    lib = get_lib()
    ptr = _as_i64(ptr)
    out = np.empty(int(ptr[-1]), np.int64)
    lib.ptr2ind(_p(ptr), len(ptr) - 1, _p(out))
    return out


def _caps(seeds, fanouts, colptr, n_edges):
    """Hop-sum bounds of the sampler's outputs (nodes, edges).

    Duplicate seeds take duplicate node slots and duplicate hop-0
    frontier entries (sampler.cpp keeps them), so the bound of a full
    neighbourhood at hop 0 is n_edges + dups * max_degree, not n_edges;
    later hops' frontiers are deduplicated, where n_edges is exact."""
    num_seeds = len(seeds)
    n_nodes = len(colptr) - 1
    frontier = num_seeds
    ncap = frontier
    ecap = 0
    dup0 = None  # computed only when a full neighbourhood at hop 0 needs it
    for h, f in enumerate(fanouts):
        f = int(f)
        if f < 0:
            e_h = int(n_edges)
            if h == 0:
                if dup0 is None:
                    dup0 = num_seeds - len(np.unique(seeds))
                if dup0:
                    max_deg = int(np.max(colptr[1:] - colptr[:-1],
                                         initial=0))
                    e_h += dup0 * max_deg
        else:
            e_h = frontier * f
        ecap += e_h
        frontier = min(e_h, n_nodes)
        ncap += frontier
    return (min(max(ncap, num_seeds + 1), n_nodes + num_seeds),
            max(ecap, 1))


def neighbor_sample_c(colptr, row, edge_perm, seeds, fanouts, replace,
                      rng_seed, node_cap=None, edge_cap=None):
    """Multi-hop fanout sampling over a CSC (colptr, row, edge_perm).
    Returns (nodes, rows, cols, edges, hop_nodes, hop_edges): the sampled
    global ids (seeds first), each sampled edge's local source and
    destination and global id, and the per-hop counts."""
    lib = get_lib()
    colptr, row = _as_i64(colptr), _as_i64(row)
    edge_perm = _as_i64(edge_perm)
    seeds, fanouts = _as_i64(seeds), _as_i64(fanouts)
    ncap_auto, ecap_auto = _caps(seeds, fanouts, colptr, len(row))
    if node_cap is None:
        node_cap = ncap_auto
    if edge_cap is None:
        edge_cap = ecap_auto
    nodes = np.empty(node_cap, np.int64)
    rows = np.empty(edge_cap, np.int64)
    cols = np.empty(edge_cap, np.int64)
    edges = np.empty(edge_cap, np.int64)
    n_nodes = np.zeros(1, np.int64)
    n_edges = np.zeros(1, np.int64)
    hop_nodes = np.zeros(len(fanouts) + 1, np.int64)
    hop_edges = np.zeros(len(fanouts), np.int64)
    rc = lib.neighbor_sample(
        _p(colptr), _p(row), _p(edge_perm), _p(seeds), len(seeds),
        _p(fanouts), len(fanouts), int(replace), rng_seed,
        node_cap, edge_cap, _p(nodes), _p(rows), _p(cols), _p(edges),
        _p(n_nodes), _p(n_edges), _p(hop_nodes), _p(hop_edges))
    if rc != 0:
        raise RuntimeError("neighbor_sample capacity exceeded")
    nn, ne = int(n_nodes[0]), int(n_edges[0])
    return (nodes[:nn], rows[:ne], cols[:ne], edges[:ne],
            hop_nodes.tolist(), hop_edges.tolist())


def neighbor_sample_many_c(colptr, row, edge_perm, seed_batches, fanouts,
                           replace, rng_seed):
    """`neighbor_sample_c` of several seed batches at once, on OpenMP
    threads. Batch b draws from its own stream, seeded from ``rng_seed``
    and b alone (sampler.cpp), so the thread count moves no sample.
    Returns one (nodes, rows, cols, edges, hop_nodes, hop_edges) a
    batch."""
    lib = get_lib()
    colptr, row = _as_i64(colptr), _as_i64(row)
    edge_perm = _as_i64(edge_perm)
    fanouts = _as_i64(fanouts)
    B = len(seed_batches)
    seeds = _as_i64(np.concatenate([np.asarray(b) for b in seed_batches]))
    seeds_ptr = _as_i64(np.cumsum([0] + [len(b) for b in seed_batches]))
    per_batch = [_caps(np.asarray(b), fanouts, colptr, len(row))
                 for b in seed_batches]
    node_cap = max(c[0] for c in per_batch)
    edge_cap = max(c[1] for c in per_batch)
    H = len(fanouts)
    nodes = np.empty(B * node_cap, np.int64)
    rows = np.empty(B * edge_cap, np.int64)
    cols = np.empty(B * edge_cap, np.int64)
    edges = np.empty(B * edge_cap, np.int64)
    n_nodes = np.zeros(B, np.int64)
    n_edges = np.zeros(B, np.int64)
    hop_nodes = np.zeros(B * (H + 1), np.int64)
    hop_edges = np.zeros(B * H, np.int64)
    status = np.zeros(B, np.int64)
    lib.neighbor_sample_many(
        _p(colptr), _p(row), _p(edge_perm), _p(seeds), _p(seeds_ptr), B,
        _p(fanouts), H, int(replace), rng_seed, node_cap, edge_cap,
        _p(nodes), _p(rows), _p(cols), _p(edges), _p(n_nodes),
        _p(n_edges), _p(hop_nodes), _p(hop_edges), _p(status))
    if (status != 0).any():
        raise RuntimeError("neighbor_sample_many capacity exceeded")
    out = []
    for b in range(B):
        nn, ne = int(n_nodes[b]), int(n_edges[b])
        out.append((nodes[b * node_cap:b * node_cap + nn],
                    rows[b * edge_cap:b * edge_cap + ne],
                    cols[b * edge_cap:b * edge_cap + ne],
                    edges[b * edge_cap:b * edge_cap + ne],
                    hop_nodes[b * (H + 1):(b + 1) * (H + 1)].tolist(),
                    hop_edges[b * H:(b + 1) * H].tolist()))
    return out


def random_walk_c(rowptr, col, starts, walk_length, rng_seed):
    """Uniform walks over a CSR: (len(starts), walk_length + 1) ids."""
    lib = get_lib()
    rowptr, col, starts = _as_i64(rowptr), _as_i64(col), _as_i64(starts)
    out = np.empty((len(starts), walk_length + 1), np.int64)
    lib.random_walk(_p(rowptr), _p(col), _p(starts), len(starts),
                    walk_length, rng_seed, _p(out))
    return out


def saint_subgraph_c(rowptr, col, edge_perm, nodes):
    """The edges among ``nodes`` (local rows and columns, global ids)."""
    lib = get_lib()
    rowptr, col = _as_i64(rowptr), _as_i64(col)
    edge_perm, nodes = _as_i64(edge_perm), _as_i64(nodes)
    cap = len(col)
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    edges = np.empty(cap, np.int64)
    ne = lib.saint_subgraph(_p(rowptr), _p(col), _p(edge_perm), _p(nodes),
                            len(nodes), _p(rows), _p(cols), _p(edges), cap)
    if ne < 0:
        raise RuntimeError("saint_subgraph capacity exceeded")
    return rows[:ne], cols[:ne], edges[:ne]


def hetero_neighbor_sample_c(csc_per_etype, et_src, et_dst, fanouts,
                             seed_nodes, seed_types, num_ntypes,
                             rng_seed, node_cap, edge_cap):
    """csc_per_etype: (colptr, row, eperm) of each edge type; fanouts:
    (num_hops, num_etypes). Returns (nodes (T, cap), node_counts,
    rows / cols / edges (E_t, cap), edge_counts)."""
    lib = get_lib()
    num_etypes = len(csc_per_etype)
    colptr_cat = _as_i64(np.concatenate(
        [c[0] for c in csc_per_etype]))
    colptr_off = _as_i64(np.concatenate(
        [[0], np.cumsum([len(c[0]) for c in csc_per_etype])]))
    row_cat = _as_i64(np.concatenate([c[1] for c in csc_per_etype]))
    eperm_cat = _as_i64(np.concatenate([c[2] for c in csc_per_etype]))
    row_off = _as_i64(np.concatenate(
        [[0], np.cumsum([len(c[1]) for c in csc_per_etype])]))
    fanouts = _as_i64(fanouts)
    num_hops = fanouts.shape[0]
    seed_nodes = _as_i64(seed_nodes)
    seed_types = _as_i64(seed_types)
    nodes = np.empty((num_ntypes, node_cap), np.int64)
    node_counts = np.zeros(num_ntypes, np.int64)
    rows = np.empty((num_etypes, edge_cap), np.int64)
    cols = np.empty((num_etypes, edge_cap), np.int64)
    edges = np.empty((num_etypes, edge_cap), np.int64)
    edge_counts = np.zeros(num_etypes, np.int64)
    rc = lib.hetero_neighbor_sample(
        num_ntypes, num_etypes, _p(_as_i64(et_src)), _p(_as_i64(et_dst)),
        _p(colptr_cat), _p(colptr_off), _p(row_cat), _p(eperm_cat),
        _p(row_off), _p(fanouts.reshape(-1)), num_hops,
        _p(seed_nodes), _p(seed_types), len(seed_nodes),
        rng_seed, node_cap, edge_cap,
        _p(nodes), _p(node_counts), _p(rows), _p(cols), _p(edges),
        _p(edge_counts))
    if rc != 0:
        raise RuntimeError("hetero_neighbor_sample capacity exceeded")
    return nodes, node_counts, rows, cols, edges, edge_counts
