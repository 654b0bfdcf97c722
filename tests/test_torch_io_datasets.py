"""The port's `io/` readers and `datasets/` against the JAX package's, on
the CPU, on files each test writes from a numpy seed (nothing is
fetched: ``GGL_TPU_OFFLINE=1`` throughout): Planetoid at cora's and
citeseer's shapes with the public, full and random splits,
`OgbNodeDataset` in its npy, npz and csv.gz layouts, `TUDataset`, the
npz datasets, `StochasticBlockModelDataset`, the real-structure loader,
and the cache rule (both packages process one root in turn, and each
reads only its own file). Every graph is held field by field, bit for
bit.
"""

import gzip
import os
import os.path as osp
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gammagl_tpu.datasets as jds
import gammagl_tpu.io as jio
import gammagl_tpu.data as jdata
from gammagl_tpu.datasets import real_structure as jreal

import gammagl_tpu_torch.datasets as tds
import gammagl_tpu_torch.io as tio
import gammagl_tpu_torch.data as tdata
from gammagl_tpu_torch.datasets import real_structure as treal

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_graph(got, want):
    assert type(got).__module__.startswith("gammagl_tpu_torch.")
    assert got.num_nodes == want.num_nodes
    assert list(got.keys()) == list(want.keys()), (list(got.keys()),
                                                  list(want.keys()))
    for k, v in want.items():
        a, b = _np(got[k]), _np(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def write_planetoid(raw_dir, name, n_lab, n_test, f, c, seed=0, gaps=0,
                    n_edges=3):
    """The eight Planetoid files (scipy matrices and the adjacency dict),
    as the JAX package's dataset tests fabricate them. ``gaps`` leaves
    that many ids out of the test block (citeseer's isolated nodes)."""
    import scipy.sparse as sp
    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_allx = n_lab + 520  # the reader takes 500 val nodes after the labels
    n = n_allx + n_test + gaps

    def onehot(k):
        y = np.zeros((k, c))
        y[np.arange(k), rng.integers(0, c, k)] = 1
        return y

    data = {"x": sp.csr_matrix(rng.random((n_lab, f))),
            "tx": sp.csr_matrix(rng.random((n_test, f))),
            "allx": sp.csr_matrix(rng.random((n_allx, f))),
            "y": onehot(n_lab), "ty": onehot(n_test),
            "ally": onehot(n_allx),
            "graph": {i: [int(v) for v in rng.integers(0, n, n_edges)]
                      for i in range(n)}}
    for k, v in data.items():
        with open(osp.join(raw_dir, f"ind.{name}.{k}"), "wb") as fh:
            pickle.dump(v, fh)
    test_idx = np.arange(n_allx, n)
    if gaps:
        test_idx = np.sort(rng.choice(test_idx[1:-1], n_test - 2,
                                      replace=False))
        test_idx = np.concatenate([[n_allx], test_idx, [n - 1]])
    rng.shuffle(test_idx)
    with open(osp.join(raw_dir, f"ind.{name}.test.index"), "w") as fh:
        fh.write("\n".join(str(i) for i in test_idx))
    return n


# -- io ----------------------------------------------------------------------

def test_txt_arrays_match_jax():
    lines = ["1, 2, 3", "", "4, 5, 6", "7,8,9"]
    for kw in ({"sep": ","}, {"sep": ",", "start": 1},
               {"sep": ",", "end": 1, "dtype": np.float32}):
        got = tio.parse_txt_array(lines, **kw)
        want = jio.parse_txt_array(lines, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,gaps", [("cora", 0), ("citeseer", 3)])
def test_read_planetoid_matches_jax(tmp_path, name, gaps):
    write_planetoid(str(tmp_path), name, 14, 20, 9, 4, seed=1, gaps=gaps)
    got = tio.read_planetoid_data(str(tmp_path), name)
    _same_graph(got, jio.read_planetoid_data(str(tmp_path), name))
    assert got.x.dtype == np.float32 and got.y.dtype == np.int64
    assert got.test_mask.sum() == 20


def _write_tu(folder, name, seed, n_graphs=7, attrs=True, labels=True,
              edge_labels=True):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    sizes = rng.integers(3, 8, n_graphs)
    start = np.concatenate([[0], np.cumsum(sizes)])
    edges = []
    for g, s in enumerate(sizes):
        for _ in range(int(s) + 2):
            a, b = rng.integers(0, s, 2) + start[g]
            edges += [(a + 1, b + 1), (b + 1, a + 1)]
    edges = np.asarray(edges)

    def put(suffix, arr, fmt):
        np.savetxt(osp.join(folder, f"{name}_{suffix}.txt"), arr, fmt=fmt,
                   delimiter=", ")

    put("A", edges, "%d")
    put("graph_indicator", np.repeat(np.arange(1, n_graphs + 1), sizes),
        "%d")
    put("graph_labels", rng.integers(1, 4, n_graphs) * 2, "%d")
    n = int(sizes.sum())
    if attrs:
        put("node_attributes", rng.normal(size=(n, 3)), "%.6f")
    if labels:
        put("node_labels", rng.integers(0, 3, n), "%d")
    if edge_labels:
        put("edge_labels", rng.integers(1, 3, len(edges)), "%d")
    return n_graphs


@pytest.mark.parametrize("kw", [{}, {"attrs": False},
                                {"labels": False, "edge_labels": False}])
def test_read_tu_matches_jax(tmp_path, kw):
    _write_tu(str(tmp_path), "TOY", 2, **kw)
    got = tio.read_tu_data(str(tmp_path), "TOY")
    want = jio.read_tu_data(str(tmp_path), "TOY")
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        _same_graph(a, b)


def _amazon_npz(path, seed, n=25, f=6):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    attr = sp.random(n, f, density=0.4, format="csr", random_state=seed)
    adj = sp.random(n, n, density=0.15, format="csr", random_state=seed + 1)
    adj.setdiag(1.0)
    adj = adj.tocsr()
    np.savez(path, attr_data=attr.data, attr_indices=attr.indices,
             attr_indptr=attr.indptr, attr_shape=attr.shape,
             adj_data=adj.data, adj_indices=adj.indices,
             adj_indptr=adj.indptr, adj_shape=adj.shape,
             labels=rng.integers(0, 3, n))


def test_read_npz_matches_jax(tmp_path):
    path = str(tmp_path / "g.npz")
    _amazon_npz(path, 3)
    got, want = tio.read_npz(path), jio.read_npz(path)
    _same_graph(got, want)
    assert not (got.edge_index[0] == got.edge_index[1]).any()


# -- datasets -----------------------------------------------------------------

@pytest.mark.parametrize("split", ["public", "full", "random"])
@pytest.mark.parametrize("name,gaps", [("cora", 0), ("citeseer", 2)])
def test_planetoid_matches_jax(tmp_path, name, gaps, split):
    """Each package processes its own copy of the raw files."""
    roots = [str(tmp_path / p) for p in ("port", "jax")]
    for root in roots:
        write_planetoid(osp.join(root, name, "raw"), name, 12, 18, 7, 3,
                        seed=4, gaps=gaps)
    kw = dict(name=name, split=split, num_train_per_class=3, num_val=10,
              num_test=15)
    got, want = tds.Planetoid(roots[0], **kw), jds.Planetoid(roots[1], **kw)
    assert len(got) == len(want) == 1
    assert got.num_classes == want.num_classes
    assert got.num_node_features == want.num_node_features == 7
    _same_graph(got[0], want[0])
    if split == "random":
        assert got[0].train_mask.sum() == 9


def test_planetoid_without_files_refuses_to_download(tmp_path):
    with pytest.raises(OSError, match="GGL_TPU_OFFLINE"):
        tds.Planetoid(str(tmp_path), "pubmed")


def test_the_cache_rule(tmp_path):
    """Both packages process one root in turn: each writes and reads its
    own file, and the port's pickle loads in a process without JAX."""
    root = str(tmp_path)
    write_planetoid(osp.join(root, "cora", "raw"), "cora", 10, 15, 5, 3)
    want = jds.Planetoid(root, "cora")[0]
    got = tds.Planetoid(root, "cora")[0]
    proc = osp.join(root, "cora", "processed")
    assert sorted(os.listdir(proc)) == ["data.pkl", "data_torch.pkl"]
    again_jax = jds.Planetoid(root, "cora")[0]
    again = tds.Planetoid(root, "cora")[0]
    for a, b in ((got, want), (again, want)):
        _same_graph(a, b)
    assert type(again_jax).__module__ == "gammagl_tpu.data.batch"
    code = ("import pickle, sys; "
            f"d = pickle.load(open({osp.join(proc, 'data_torch.pkl')!r}, "
            "'rb')); "
            "assert type(d).__module__ == 'gammagl_tpu_torch.data.batch'; "
            "assert d.x.shape == (" + str(got.num_nodes) + ", 5); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gammagl_tpu', 'flax')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        tdata.Graph.load(osp.join(proc, "data.pkl"))


def test_force_reload_and_views(tmp_path):
    root = str(tmp_path)
    write_planetoid(osp.join(root, "cora", "raw"), "cora", 10, 15, 5, 3)
    ds = tds.Planetoid(root, "cora")
    path = ds.processed_paths[0]
    os.utime(path, (0, 0))
    tds.Planetoid(root, "cora", force_reload=True)
    assert os.stat(path).st_mtime > 0
    seen = []
    ds = tds.Planetoid(root, "cora", transform=lambda g: seen.append(1) or g)
    ds[0]
    assert seen == [1] and repr(ds) == "Planetoid(1)"


def _ogb_fixture(root, layout, seed=0, n=40, e=150, f=6):
    rng = np.random.default_rng(seed)
    base = osp.join(root, "ogbn_arxiv")
    raw, split = osp.join(base, "raw"), osp.join(base, "split", "time")
    os.makedirs(raw)
    os.makedirs(split)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = rng.integers(0, n, (2, e)).astype(np.int64)
    y = rng.integers(0, 5, n).astype(np.float64)
    y[3] = np.nan
    if layout == "npy":
        np.save(osp.join(raw, "node_feat.npy"), x)
        np.save(osp.join(raw, "edge_index.npy"), ei.T.copy())  # (E, 2)
        np.save(osp.join(raw, "node_label.npy"), y)
    elif layout == "npz":
        np.savez(osp.join(raw, "data.npz"), node_feat=x, edge_index=ei)
        np.savez(osp.join(raw, "node-label.npz"), node_label=y)
    else:
        def write(path, arr, fmt):
            with gzip.open(path, "wt") as fh:
                for row in np.atleast_2d(arr):
                    fh.write(",".join(fmt % v for v in np.atleast_1d(row))
                             + "\n")
        write(osp.join(raw, "node-feat.csv.gz"), x, "%.8e")
        write(osp.join(raw, "edge.csv.gz"), ei.T, "%d")
        write(osp.join(raw, "node-label.csv.gz"),
              np.nan_to_num(y, nan=1.0)[:, None], "%d")
    for name, idx in (("train", np.arange(0, 20)),
                      ("valid", np.arange(20, 30))):
        if layout == "csv":
            with gzip.open(osp.join(split, f"{name}.csv.gz"), "wt") as fh:
                fh.write("\n".join(str(i) for i in idx) + "\n")
        else:
            np.save(osp.join(split, f"{name}.npy"), idx)


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("layout", ["npy", "npz", "csv"])
def test_ogb_node_dataset_matches_jax(tmp_path, layout, undirected):
    roots = [str(tmp_path / p) for p in ("port", "jax")]
    for root in roots:
        _ogb_fixture(root, layout)
    got = tds.OgbNodeDataset(roots[0], "ogbn-arxiv",
                             to_undirected=undirected)
    want = jds.OgbNodeDataset(roots[1], "ogbn-arxiv",
                              to_undirected=undirected)
    assert got.num_classes == want.num_classes and len(got) == 1
    _same_graph(got[0], want[0])
    assert got.processed_file_names == "meta.json"
    assert open(got.processed_paths[0]).read() == open(
        want.processed_paths[0]).read()
    if layout == "npy" and not undirected:
        assert isinstance(got[0].x, np.memmap) and not got[0].x.flags.writeable


def test_ogb_shares_the_jax_meta_marker(tmp_path):
    root = str(tmp_path)
    _ogb_fixture(root, "csv")
    jds.OgbNodeDataset(root, "ogbn-arxiv")
    got = tds.OgbNodeDataset(root, "ogbn-arxiv")  # reads the npy the JAX
    _same_graph(got[0], jds.OgbNodeDataset(root, "ogbn-arxiv")[0])
    with pytest.raises(RuntimeError, match="not staged"):
        tds.OgbNodeDataset(root, "ogbn-products")


@pytest.mark.parametrize("kw", [{}, {"pre_filter": "small"}])
def test_tu_dataset_matches_jax(tmp_path, kw):
    roots = [str(tmp_path / p) for p in ("port", "jax")]
    for root in roots:
        _write_tu(osp.join(root, "TOY", "raw"), "TOY", 5, n_graphs=9)
    if kw:
        kw = {"pre_filter": lambda g: g.num_nodes < 6}
    got, want = tds.TUDataset(roots[0], "TOY", **kw), jds.TUDataset(
        roots[1], "TOY", **kw)
    assert len(got) == len(want) and got.num_classes == want.num_classes
    assert got.num_node_features == want.num_node_features
    for i in range(len(want)):
        _same_graph(got[i], want[i])
    _same_graph(got.data, want.data)
    order = np.random.default_rng(0)
    view = got.shuffle(np.random.default_rng(0))
    perm = order.permutation(len(want))
    for i, j in enumerate(perm):
        _same_graph(view[i], want[int(j)])
    mask = np.arange(len(want)) % 2 == 0
    assert len(got[mask]) == len(want[mask])
    for a, b in zip(got[1:4], want[1:4]):
        _same_graph(a, b)


@pytest.mark.parametrize("cls,name,fname", [
    ("Amazon", "photo", "amazon_electronics_photo.npz"),
    ("Coauthor", "physics", "ms_academic_phy.npz")])
def test_amazon_coauthor_match_jax(tmp_path, cls, name, fname):
    roots = [str(tmp_path / p) for p in ("port", "jax")]
    for root in roots:
        os.makedirs(osp.join(root, name, "raw"))
        _amazon_npz(osp.join(root, name, "raw", fname), 6)
    got = getattr(tds, cls)(roots[0], name)
    _same_graph(got[0], getattr(jds, cls)(roots[1], name)[0])


@pytest.mark.parametrize("cls,keys", [
    ("FacebookPagePage", ("features", "edges", "target")),
    ("DeezerEurope", ("x", "edge_index", "y")),
    ("GitHub", ("features", "edge_index", "y"))])
def test_single_npz_datasets_match_jax(tmp_path, cls, keys):
    rng = np.random.default_rng(7)
    n = 12
    arrays = {keys[0]: rng.normal(size=(n, 4)),
              keys[1]: rng.integers(0, n, (2, 30)),
              keys[2]: rng.integers(0, 2, n)}
    if keys[1] == "edges":
        arrays["edges"] = arrays["edges"].T
    roots = [str(tmp_path / p) for p in ("port", "jax")]
    for root in roots:
        os.makedirs(osp.join(root, "raw"))
        np.savez(osp.join(root, "raw", getattr(tds, cls).file_name),
                 **arrays)
    _same_graph(getattr(tds, cls)(roots[0])[0],
                getattr(jds, cls)(roots[1])[0])


def test_sbm_dataset_and_graph_match_jax(tmp_path):
    kw = dict(num_nodes=90, num_classes=3, feat_dim=8, seed=2)
    got = tds.StochasticBlockModelDataset(str(tmp_path / "port"), **kw)
    want = jds.StochasticBlockModelDataset(str(tmp_path / "jax"), **kw)
    _same_graph(got[0], want[0])
    assert got.processed_file_names.endswith("_torch.pkl")
    for args in ((200, 4, 32), (57, 5, 6, 4, 0.7, 3, 0.5)):
        _same_graph(tds.synthetic_community_graph(*args),
                    jds.synthetic_community_graph(*args))


def test_real_structure_matches_jax(tmp_path, monkeypatch):
    """The synthetic stand-in without a copy; a copy named by
    ``GGL_TPU_REFDATA``, read by both."""
    import scipy.sparse as sp
    monkeypatch.delenv("GGL_TPU_REFDATA", raising=False)
    monkeypatch.delenv("GGL_REFERENCE_ROOT", raising=False)
    for name in ("cora", "pubmed"):
        if jds.real_structure_available(name):
            continue  # a bundled copy: both read it below
        got, want = tds.load_real_structure(name, seed=3), \
            jds.load_real_structure(name, seed=3)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (treal._SIZES[name], False)
    adj = sp.random(2708, 2708, density=0.001, format="csr", random_state=0)
    np.savez(tmp_path / "cora_add_0.75.npz", data=adj.data,
             indices=adj.indices, indptr=adj.indptr, shape=adj.shape)
    monkeypatch.setenv("GGL_TPU_REFDATA", str(tmp_path))
    # the JAX module reads the variable once, at import
    monkeypatch.setattr(jreal, "_SEARCH_PATHS", (str(tmp_path),))
    assert tds.real_structure_available("cora", "0.75")
    got = tds.load_real_structure("cora", "0.75")
    want = jds.load_real_structure("cora", "0.75")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (2708, True)
