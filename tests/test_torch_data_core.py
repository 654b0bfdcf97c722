"""The port's data core against the JAX package's, on the CPU: the four
`utils/` helpers (mask, degree, coalesce, undirected), `Graph`'s whole
surface (`BaseGraph`'s mapping protocol, sizes, degrees, the batching
protocol, plans, conversions, copies, `to_heterogeneous` /
`HeteroGraph.to_homogeneous`, `dump` / `load`), `pad_graph` (and a padded
graph through GCNModel's COO route), `BatchGraph`, `EdgeIndex`, the
feature and graph stores, and `download` / `config`.

Every input is made from a numpy seed; integer and boolean results are
held bit for bit, float32 model outputs at 1e-5 of max |out| (the f32
rule of ROADMAP section C).
"""

import gzip
import io
import os
import os.path as osp
import pickle
import tarfile
import zipfile

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import gammagl_tpu.data as jdata
import gammagl_tpu.data.config as jconfig
import gammagl_tpu.data.download as jdownload
import gammagl_tpu.utils as jutils
from gammagl_tpu.models import GCNModel as JaxGCNModel

import gammagl_tpu_torch.data as tdata
import gammagl_tpu_torch.data.config as tconfig
import gammagl_tpu_torch.data.download as tdownload
import gammagl_tpu_torch.utils as tutils
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.ops.cuda import CSRPlan
from gammagl_tpu_torch.utils import load_jax_params


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _edges(seed, n=30, e=90, loops=True):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    if not loops:
        ei = ei[:, ei[0] != ei[1]]
    return ei.astype(np.int64), n


def _graphs(seed, n=30, e=90, f=5):
    """The same graph in both packages: x, edge_index, edge_attr, y and
    a mask."""
    rng = np.random.default_rng(seed)
    ei, _ = _edges(seed, n, e)
    fields = dict(x=rng.normal(size=(n, f)).astype(np.float32),
                  edge_index=ei,
                  edge_attr=rng.normal(size=(e, 3)).astype(np.float32),
                  y=rng.integers(0, 4, n).astype(np.int64),
                  train_mask=rng.random(n) < 0.5)
    return jdata.Graph(**fields), tdata.Graph(**fields)


# -- utils -------------------------------------------------------------------

@pytest.mark.parametrize("size", [None, 12, 40])
def test_index_to_mask_matches_jax(size):
    idx = np.array([0, 3, 3, 7, 11, -1, -12, 40, 45])
    if size is None:
        idx = idx[(idx >= 0) & (idx < 12)]
    want = jutils.index_to_mask(idx, size)
    _same(tutils.index_to_mask(idx, size), want)
    got = tutils.index_to_mask(torch.from_numpy(idx), size)
    assert got.dtype == torch.bool
    _same(got, want)


def test_mask_to_index_matches_jax():
    mask = np.random.default_rng(0).random(50) < 0.3
    want = jutils.mask_to_index(mask)
    _same(tutils.mask_to_index(mask), want)
    got = tutils.mask_to_index(torch.from_numpy(mask))
    assert got.dtype == torch.int64
    _same(got, want)


@pytest.mark.parametrize("num_nodes", [None, 30, 25])
def test_degree_matches_jax_and_drops_out_of_range_ids(num_nodes):
    ei, _ = _edges(1)
    index = np.concatenate([ei[1], [30, 31, 40]])  # pad ids past n
    n = num_nodes if num_nodes is not None else 41
    want = jutils.degree(jnp.asarray(index), n)
    got = tutils.degree(index, num_nodes)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _same(got, want)
    got = tutils.degree(torch.from_numpy(index), num_nodes)
    assert got.dtype == torch.float32
    _same(got, want)


def test_degree_counts_in_float32_past_the_bf16_limit():
    """ROADMAP C1: JAX's bf16 count stops at 256; the port's does not."""
    index = np.zeros(300, np.int64)
    assert float(jutils.degree(jnp.asarray(index), 1,
                               dtype=jnp.bfloat16)[0]) == 256.0
    assert float(tutils.degree(torch.from_numpy(index), 1,
                               dtype=torch.bfloat16)[0]) == 300.0


@pytest.mark.parametrize("reduce", ["sum", "add", "mean", "max", "min",
                                    "mul"])
def test_coalesce_matches_jax(reduce):
    ei, n = _edges(2, n=8, e=60)
    attr = np.random.default_rng(2).normal(size=(60, 2)).astype(np.float32)
    want = jutils.coalesce(ei, attr, num_nodes=n, reduce=reduce)
    got = tutils.coalesce(ei, attr, num_nodes=n, reduce=reduce)
    _same(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    _same(tutils.coalesce(ei), jutils.coalesce(ei))


@pytest.mark.parametrize("by_row", [True, False])
def test_sort_edge_index_matches_jax(by_row):
    ei, n = _edges(3)
    attrs = [np.arange(90), np.arange(90) * 2.0]
    _same(tutils.sort_edge_index(ei, sort_by_row=by_row),
          jutils.sort_edge_index(ei, sort_by_row=by_row))
    got = tutils.sort_edge_index(ei, attrs, n, by_row)
    want = jutils.sort_edge_index(ei, attrs, n, by_row)
    _same(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        _same(a, b)


def test_to_undirected_matches_jax():
    ei, n = _edges(4, loops=False)
    attr = np.arange(ei.shape[1], dtype=np.float32)
    got = tutils.to_undirected(ei, attr, num_nodes=n)
    want = jutils.to_undirected(ei, attr, num_nodes=n)
    _same(got[0], want[0])
    _same(got[1], want[1])
    und = tutils.to_undirected(ei, num_nodes=n)
    _same(und, jutils.to_undirected(ei, num_nodes=n))
    assert tutils.is_undirected(und) and jutils.is_undirected(und)
    assert tutils.is_undirected(ei) == jutils.is_undirected(ei) is False


# -- Graph --------------------------------------------------------------------

def test_mapping_protocol_matches_jax():
    jg, tg = _graphs(5)
    assert isinstance(tg, tdata.BaseGraph)
    assert list(tg.keys()) == list(jg.keys())
    assert list(tg.to_dict()) == list(jg.to_dict())
    for k, v in jg.items():
        _same(tg[k], v)
        _same(getattr(tg, k), v)
    for g in (jg, tg):
        g["extra"] = np.arange(3)
        assert "extra" in g and g.extra is g["extra"]
        del g["extra"]
        assert "extra" not in g
        with pytest.raises(AttributeError):
            g.extra
    assert [_np(v).shape for v in tg.values()] == [
        _np(v).shape for v in jg.values()]


def test_sizes_and_features_match_jax():
    jg, tg = _graphs(6)
    for name in ("num_nodes", "num_edges", "num_node_features",
                 "num_features", "num_edge_features"):
        assert getattr(tg, name) == getattr(jg, name), name
    bare = dict(edge_index=np.array([[0, 4], [1, 2]]))
    assert tdata.Graph(**bare).num_nodes == jdata.Graph(**bare).num_nodes
    assert tdata.Graph(**bare).num_node_features == 0
    one = dict(edge_index=bare["edge_index"], edge_attr=np.ones(2))
    assert (tdata.Graph(**one).num_edge_features
            == jdata.Graph(**one).num_edge_features == 0)


def test_degrees_match_jax_on_the_host_and_on_tensors():
    jg, tg = _graphs(7)
    for name in ("in_degree", "out_degree"):
        want = getattr(jg, name)
        got = getattr(tg, name)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        _same(got, want)
        got = getattr(tg.tensor("cpu"), name)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        _same(got, want)


def test_batching_protocol_and_sorted_edges_match_jax():
    jg, tg = _graphs(8)
    for key in ("edge_index", "x", "y", "face", "node_index", "edge_attr"):
        assert tg.__cat_dim__(key) == jg.__cat_dim__(key)
        assert tg.__inc__(key) == jg.__inc__(key)
    for by in ("dst", "src"):
        got, want = tg.sorted_edges(by), jg.sorted_edges(by)
        _same(got[0], want[0])
        _same(got[1], want[1])


def test_csc_plan_is_the_transposed_csr_and_not_shared_by_copies():
    _, tg = _graphs(9)
    ei = tg.edge_index
    plan = tg.csc_plan()
    assert isinstance(plan, CSRPlan) and tg.csc_plan() is plan
    want = tdata.Graph(edge_index=ei[::-1].copy(), num_nodes=30).csr_plan()
    _same(plan.rowptr, want.rowptr)
    _same(plan.col, want.col)
    _same(plan.perm, want.perm)
    for copy in (tg.clone(), tg.copy(), tg.deepcopy(), tg.tensor("cpu"),
                 tg.numpy()):
        assert copy._csc_plan is None and copy._csr_plan is None


def test_tensor_numpy_and_copies_keep_values(monkeypatch):
    jg, tg = _graphs(10)
    t = tg.tensor("cpu")
    assert t is not tg and t.num_nodes == tg.num_nodes
    for k, v in jg.items():
        assert isinstance(t[k], torch.Tensor)
        _same(t[k], v)
        assert isinstance(t.numpy()[k], np.ndarray)
        _same(t.numpy()[k], v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.tensor()  # the card by default; no fallback to the CPU
    shallow, deep = tg.copy(), tg.deepcopy()
    assert shallow.x is tg.x and deep.x is not tg.x
    _same(deep.x, tg.x)
    deep.x[0, 0] = 99.0
    assert tg.x[0, 0] != 99.0


def test_tensor_of_a_read_only_map_warns_nothing(tmp_path, recwarn):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    np.save(tmp_path / "x.npy", x)
    g = tdata.Graph(x=np.load(tmp_path / "x.npy", mmap_mode="r"),
                    edge_index=np.array([[0], [1]]))
    got = g.tensor("cpu")
    assert not [w for w in recwarn if "writable" in str(w.message)]
    _same(got.x, x)


@pytest.mark.parametrize("names", [False, True])
def test_to_heterogeneous_and_back_match_jax(names):
    rng = np.random.default_rng(11)
    jg, tg = _graphs(11)
    node_type = rng.integers(0, 3, 30)
    edge_type = rng.integers(0, 4, 90)
    kw = dict(node_type=node_type, edge_type=edge_type)
    if names:
        kw.update(node_type_names=["a", "b", "c"],
                  edge_type_names=[("a", f"r{i}", "c") for i in range(4)])
    jh, th = jg.to_heterogeneous(**kw), tg.to_heterogeneous(**kw)
    assert th.metadata() == jh.metadata()
    for nt in jh.node_types:
        assert th[nt].num_nodes == jh[nt].num_nodes
        _same(th[nt].x, jh[nt].x)
    for et in jh.edge_types:
        _same(th[et].edge_index, jh[et].edge_index)
    jb, tb = jh.to_homogeneous(), th.to_homogeneous()
    assert tb.num_nodes == jb.num_nodes
    assert list(tb.keys()) == list(jb.keys())
    for k, v in jb.items():
        _same(tb[k], v)


def test_to_homogeneous_of_a_typed_graph_matches_jax():
    rng = np.random.default_rng(12)
    parts = {"paper": 7, "author": 5}
    stores = {}
    for nt, n in parts.items():
        stores[nt] = {"x": rng.normal(size=(n, 4)).astype(np.float32)}
    for et, (s, d) in {("author", "writes", "paper"): (5, 7),
                       ("paper", "cites", "paper"): (7, 7)}.items():
        stores[et] = {"edge_index": np.stack(
            [rng.integers(0, s, 9), rng.integers(0, d, 9)])}
    jh, th = jdata.HeteroGraph(stores), tdata.HeteroGraph(stores)
    assert th.metadata() == jh.metadata()
    for kw in ({}, {"add_node_type": False, "add_edge_type": False}):
        jb, tb = jh.to_homogeneous(**kw), th.to_homogeneous(**kw)
        assert list(tb.keys()) == list(jb.keys()) and tb.num_nodes == 12
        for k, v in jb.items():
            _same(tb[k], v)
    th["paper"].x = th["paper"].x[:, :2]  # widths differ: no x
    assert "x" not in th.to_homogeneous()
    assert th.get_node_store("author") is th["author"]
    assert th.get_edge_store("author", "writes", "paper") is th[
        ("author", "writes", "paper")]


def test_hetero_tensor_and_numpy_in_place():
    th = tdata.HeteroGraph({"a": {"x": np.ones((3, 2), np.float32)},
                            ("a", "r", "a"): {"edge_index": np.array(
                                [[0, 1], [1, 2]])}})
    assert th.tensor("cpu") is th
    assert isinstance(th["a"].x, torch.Tensor)
    assert isinstance(th[("a", "r", "a")].edge_index, torch.Tensor)
    plans = th.csr_plans()  # plans read tensors through the host
    assert plans[("a", "r", "a")].num_edges == 2
    assert th.numpy() is th and isinstance(th["a"].x, np.ndarray)


def test_dump_load_round_trip_and_refuse_the_jax_package(tmp_path):
    jg, tg = _graphs(13)
    path = str(tmp_path / "g.pkl")
    tg.tensor("cpu").dump(path)
    back = tdata.Graph.load(path)
    assert type(back) is tdata.Graph and back.num_nodes == tg.num_nodes
    for k, v in tg.items():
        assert isinstance(back[k], np.ndarray)
        _same(back[k], v)
    jpath = str(tmp_path / "jax.pkl")
    jg.dump(jpath)
    with pytest.raises(pickle.UnpicklingError, match="JAX package"):
        tdata.Graph.load(jpath)


# -- padding ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 64, 65, 100, 1000, 12345])
def test_size_bucket_matches_jax(n):
    assert tdata.size_bucket(n) == jdata.size_bucket(n)
    assert tdata.size_bucket(n, 8, 2.0) == jdata.size_bucket(n, 8, 2.0)


def test_pad_to_matches_jax():
    a = np.arange(12).reshape(3, 4)
    for size, axis, fill in ((5, 0, 0), (7, 1, -1), (3, 0, 9)):
        _same(tdata.pad_to(a, size, axis, fill),
              jdata.pad_to(a, size, axis, fill))
    with pytest.raises(ValueError):
        tdata.pad_to(a, 2)


@pytest.mark.parametrize("kw", [{}, {"bucket": True},
                                {"num_nodes": 40, "num_edges": 100}])
def test_pad_graph_matches_jax(kw):
    jg, tg = _graphs(14)
    jp, tp = jdata.pad_graph(jg, **kw), tdata.pad_graph(tg.tensor("cpu"),
                                                         **kw)
    assert tp.num_nodes == jp.num_nodes and tp.num_edges == jp.num_edges
    assert list(tp.keys()) == list(jp.keys())
    for k, v in jp.items():
        _same(tp[k], v)


def _gcn_pair(f, hidden, classes, seed=0):
    jmodel = JaxGCNModel(hidden_dim=hidden, num_class=classes, num_layers=2,
                         drop_rate=0.0)
    x = jnp.zeros((4, f), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), x,
                         jnp.asarray([[0, 1], [1, 2]]))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = GCNModel(hidden_dim=hidden, num_class=classes, num_layers=2,
                     drop_rate=0.0)
    return jmodel, params, load_jax_params(model, params).eval()


def test_padded_graph_through_gcn_coo_route_matches_jax_on_real_rows():
    """The pads point at num_nodes: the port's COO route clamps and drops
    them as the JAX one does, and raises no index error (on the card,
    no device assert); real rows agree with JAX and with the unpadded
    graph."""
    jg, tg = _graphs(15)
    tg = tg.add_self_loop()
    jp = jdata.pad_graph(jg.add_self_loop(), bucket=True)
    tp = tdata.pad_graph(tg, bucket=True)
    assert tp.num_nodes > tg.num_nodes and tp.num_edges > tg.num_edges
    jmodel, params, model = _gcn_pair(5, 8, 4)
    want = np.asarray(jmodel.apply(params, jnp.asarray(jp.x),
                                   jnp.asarray(jp.edge_index)))
    with torch.no_grad():
        got = model(torch.from_numpy(tp.x),
                    torch.from_numpy(tp.edge_index)).numpy()
        alone = model(torch.from_numpy(tg.x),
                      torch.from_numpy(tg.edge_index)).numpy()
    real = tp.node_mask
    scale = float(np.abs(want[real]).max())
    np.testing.assert_allclose(got[real], want[real], rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(got[real], alone, rtol=0, atol=1e-5 * scale)
    assert tp.in_degree[real].sum() == tg.num_edges  # pads dropped


def test_csr_plan_of_a_padded_graph_raises_in_both_packages():
    jg, tg = _graphs(16)
    with pytest.raises(ValueError):
        jdata.pad_graph(jg, bucket=True).csr_plan()
    with pytest.raises(ValueError):
        tdata.pad_graph(tg, bucket=True).csr_plan()


# -- BatchGraph ---------------------------------------------------------------

def _graph_list(pkg, seed, k=4, scalar_y=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n, e = int(rng.integers(3, 9)), int(rng.integers(2, 15))
        out.append(pkg.Graph(
            x=rng.normal(size=(n, 3)).astype(np.float32),
            edge_index=np.stack([rng.integers(0, n, e),
                                 rng.integers(0, n, e)]),
            edge_attr=rng.normal(size=(e, 2)).astype(np.float32),
            y=(np.int64(i % 2) if scalar_y
               else rng.integers(0, 3, n).astype(np.int64)),
            node_index=rng.integers(0, n, 2)))
    return out


@pytest.mark.parametrize("scalar_y", [True, False])
@pytest.mark.parametrize("kw", [{}, {"follow_batch": ["x", "edge_attr"]},
                                {"exclude_keys": ["edge_attr"]}])
def test_batch_from_data_list_matches_jax(scalar_y, kw):
    jb = jdata.BatchGraph.from_data_list(_graph_list(jdata, 17, 5, scalar_y),
                                         **kw)
    tb = tdata.BatchGraph.from_data_list(_graph_list(tdata, 17, 5, scalar_y),
                                         **kw)
    assert isinstance(tb, tdata.Graph)
    assert tb.num_graphs == jb.num_graphs == 5
    assert tb.num_nodes == jb.num_nodes
    assert list(tb.keys()) == list(jb.keys())
    for k, v in jb.items():
        _same(tb[k], v)
    assert set(tb._slices) == set(jb._slices)
    for k, v in jb._slices.items():
        _same(tb._slices[k], v)
    for a, b in zip(tb.to_data_list(), jb.to_data_list()):
        assert a.num_nodes == b.num_nodes and list(a.keys()) == list(b.keys())
        for k, v in b.items():
            _same(a[k], v)


def test_batch_round_trips_its_graphs():
    graphs = _graph_list(tdata, 18, 6)
    batch = tdata.BatchGraph.from_data_list(graphs)
    for a, b in zip(batch.to_data_list(), graphs):
        assert a.num_nodes == b.num_nodes
        for k in ("x", "edge_index", "edge_attr", "node_index"):
            _same(a[k], b[k])
        _same(a.y, np.asarray(b.y).reshape(1))
    on_device = batch.tensor("cpu")
    assert isinstance(on_device, tdata.BatchGraph)
    assert isinstance(on_device.batch, torch.Tensor)
    plan = batch.csr_plan()
    assert plan.num_edges == sum(g.num_edges for g in graphs)
    with pytest.raises(RuntimeError):
        tdata.BatchGraph().to_data_list()


# -- EdgeIndex and the stores -------------------------------------------------

@pytest.mark.parametrize("order", [None, "row", "col"])
def test_edge_index_matches_jax(order):
    ei, _ = _edges(19)
    if order is not None:
        ei = ei[:, np.argsort(ei[0 if order == "row" else 1],
                              kind="stable")]
    je, te = jdata.EdgeIndex(ei, sort_order=order), tdata.EdgeIndex(
        ei, sort_order=order)
    assert te.sparse_size == je.sparse_size and te.num_edges == je.num_edges
    for got, want in ((te.get_csr(), je.get_csr()),
                      (te.get_csc(), je.get_csc())):
        for a, b in zip(got, want):
            _same(a, b)
    srt, perm = te.sort_by("col")
    _same(srt.data, je.sort_by("col")[0].data)
    _same(perm, je.sort_by("col")[1])
    _same(np.asarray(te), np.asarray(je))
    _same(te[1], je[1])
    sized = tdata.EdgeIndex(torch.from_numpy(ei), sparse_size=(40, 35))
    _same(sized.get_csr()[0],
          jdata.EdgeIndex(ei, sparse_size=(40, 35)).get_csr()[0])


def test_feature_store_matches_jax():
    rng = np.random.default_rng(20)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    rows = np.array([1, 4, 7])
    stores = (jdata.InMemoryFeatureStore(), tdata.InMemoryFeatureStore())
    for s in stores:
        s["paper", "x"] = x.copy()
        s.put_tensor(np.zeros((3, 3), np.float32), "paper", "x", index=rows)
        s.put_tensor(np.arange(4), "author", "id")
    j, t = stores
    _same(t["paper", "x"], j["paper", "x"])
    _same(t["paper", "x", rows[:2]], j["paper", "x", rows[:2]])
    _same(t.get_tensor("paper", "x", torch.tensor([0, 9])),
          j.get_tensor("paper", "x", np.array([0, 9])))
    got = t.multi_get_tensor([tdata.TensorAttr("author", "id"),
                              tdata.TensorAttr("paper", "x", [2])])
    want = j.multi_get_tensor([jdata.TensorAttr("author", "id"),
                               jdata.TensorAttr("paper", "x", [2])])
    for a, b in zip(got, want):
        _same(a, b)
    assert [(a.group_name, a.attr_name) for a in t.get_all_tensor_attrs()] \
        == [(a.group_name, a.attr_name) for a in j.get_all_tensor_attrs()]
    t.put_tensor(torch.ones(2), "author", "w")
    assert isinstance(t["author", "w"], np.ndarray)
    assert t.remove_tensor("author", "id") and not t.remove_tensor("a", "b")
    with pytest.raises(KeyError):
        t["author", "id"]
    attr = tdata.TensorAttr("g")
    assert not attr.is_fully_specified()
    assert attr.update(tdata.TensorAttr(None, "a", 3)) == tdata.TensorAttr(
        "g", "a", 3)


@pytest.mark.parametrize("layout", ["coo", "csr", "csc"])
def test_graph_store_matches_jax(layout):
    ei, n = _edges(21)
    jstore, tstore = jdata.InMemoryGraphStore(), tdata.InMemoryGraphStore()
    rel = ("a", "to", "b")
    for store, pkg in ((jstore, jdata), (tstore, tdata)):
        coo = pkg.InMemoryGraphStore()
        coo.put_edge_index(ei, edge_type=rel, layout="coo", size=(n, n))
        given = coo.get_edge_index(edge_type=rel, layout=layout, size=(n, n))
        store.put_edge_index(given, edge_type=rel, layout=layout,
                             size=(n, n))
        store.put_edge_index(ei, edge_type="plain")
    for lay in ("coo", "csr", "csc"):
        for et in (rel, "plain"):
            got = tstore.get_edge_index(edge_type=et, layout=lay)
            want = jstore.get_edge_index(edge_type=et, layout=lay)
            if lay == "coo":
                got, want = [got], [want]
            for a, b in zip(got, want):
                _same(a, b)
    assert tdata.EdgeAttr(layout="csr").layout is tdata.EdgeLayout.CSR
    assert [a.edge_type for a in tstore.get_all_edge_attrs()] == [
        a.edge_type for a in jstore.get_all_edge_attrs()]
    with pytest.raises(KeyError):
        tstore.get_edge_index(edge_type="missing")


# -- download and config ------------------------------------------------------

def test_offline_refuses_before_the_network(monkeypatch, tmp_path):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")

    def no_network(*a, **k):
        raise AssertionError("the network was touched")

    monkeypatch.setattr("socket.gethostbyname", no_network)
    monkeypatch.setattr("urllib.request.urlopen", no_network)
    assert tdownload.offline() and jdownload.offline()
    assert tdownload.network_available() is False
    with pytest.raises(OSError, match="GGL_TPU_OFFLINE"):
        tdownload.download_url("https://example.org/a.bin", str(tmp_path))
    (tmp_path / "a.bin").write_bytes(b"staged")
    assert tdownload.download_url("https://example.org/a.bin?x=1",
                                  str(tmp_path)) == str(tmp_path / "a.bin")
    for value, want in (("0", False), ("", False), ("yes", True)):
        monkeypatch.setenv("GGL_TPU_OFFLINE", value)
        assert tdownload.offline() is jdownload.offline() is want


def test_extractors_unpack_archives_the_test_writes(tmp_path):
    payload = {"a.txt": b"alpha", "d/b.txt": b"beta"}
    zpath, tpath = tmp_path / "x.zip", tmp_path / "x.tar.gz"
    with zipfile.ZipFile(zpath, "w") as z:
        for name, data in payload.items():
            z.writestr(name, data)
    with tarfile.open(tpath, "w:gz") as t:
        for name, data in payload.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))
    gpath = tmp_path / "c.txt.gz"
    with gzip.open(gpath, "wb") as g:
        g.write(b"gamma")
    for pkg in (tdownload, jdownload):
        out = tmp_path / pkg.__name__.split(".")[0]
        pkg.extract_zip(str(zpath), str(out / "zip"))
        pkg.extract_tar(str(tpath), str(out / "tar"))
        for sub in ("zip", "tar"):
            for name, data in payload.items():
                assert (out / sub / name).read_bytes() == data
        os.makedirs(out / "gz")
        got = pkg.extract_gz(str(gpath), str(out / "gz"))
        assert got == str(out / "gz" / "c.txt")
        assert open(got, "rb").read() == b"gamma"


def test_config_reads_the_same_file_and_switch(monkeypatch, tmp_path):
    path = tmp_path / "config.json"
    for mod in (tconfig, jconfig):
        monkeypatch.setattr(mod, "_CONFIG_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "_CONFIG_PATH", str(path))
        monkeypatch.setattr(mod, "_cache", None)
    monkeypatch.delenv("GGL_TPU_DATASET_ROOT", raising=False)
    assert tconfig.get_config() == jconfig.get_config() == tconfig.DEFAULTS
    tconfig.save_config({"dataset_root": str(tmp_path / "ds")})
    monkeypatch.setattr(jconfig, "_cache", None)
    assert tdata.get_dataset_root() == jdata.get_dataset_root() == str(
        tmp_path / "ds")
    assert tconfig.get_config() is tconfig.get_config()  # cached
    monkeypatch.setattr(tconfig, "_cache", None)
    monkeypatch.setattr(jconfig, "_cache", None)
    monkeypatch.setenv("GGL_TPU_DATASET_ROOT", str(tmp_path / "env"))
    assert tdata.get_dataset_root() == jdata.get_dataset_root() == str(
        tmp_path / "env")
    path.write_text("{not json")
    monkeypatch.setattr(tconfig, "_cache", None)
    assert tconfig.get_config()["mesh_axis_names"] == ["dp"]
    assert osp.exists(path)
