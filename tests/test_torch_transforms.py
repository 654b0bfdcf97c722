"""The port's `transforms/` and `utils/negative_sampling.py` against the
JAX package's: host-side numpy on each package's own `Graph` /
`HeteroGraph`, fed the same arrays from a seed and the same
``np.random.default_rng`` seeds, must give the same arrays bit for bit
(keys in the same order, dtypes, shapes, values). One exception:
`normalize_adj_for_vgae`'s weights, which the JAX package computes with
a tensor op (XLA), are held at rtol 1e-6.
"""

import importlib
import os.path as osp
import sys

import numpy as np
import pytest
import scipy.sparse as sp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.data as jdata  # noqa: E402
import gammagl_tpu.transforms as jt  # noqa: E402
jns = importlib.import_module("gammagl_tpu.utils.negative_sampling")
from tests.test_torch_typed_datasets import _same  # noqa: E402

import gammagl_tpu_torch.data as tdata  # noqa: E402
import gammagl_tpu_torch.transforms as tt  # noqa: E402
import gammagl_tpu_torch.utils as tutils  # noqa: E402

N = 24


def _arrays(seed=0, n=N, e=70, f=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return {"x": x, "edge_index": ei.astype(np.int64),
            "edge_attr": rng.random((e, 3)).astype(np.float32),
            "y": rng.integers(0, 3, n)}


def _pair(keys=("x", "edge_index", "y"), **kw):
    a = _arrays(**kw)
    return (tdata.Graph(**{k: a[k].copy() for k in keys}),
            jdata.Graph(**{k: a[k].copy() for k in keys}))


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif hasattr(want, "_store") or hasattr(want, "node_types"):
        _same(got, want)
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- negative sampling ---------------------------------------------------

@pytest.mark.parametrize("force_undirected", [False, True])
@pytest.mark.parametrize("num_neg", [None, 31])
def test_negative_sampling_is_jax_stream(force_undirected, num_neg):
    ei = _arrays()["edge_index"]
    got = tutils.negative_sampling(ei, N, num_neg, force_undirected=
                                   force_undirected,
                                   rng=np.random.default_rng(5))
    want = jns.negative_sampling(ei, N, num_neg, force_undirected=
                                 force_undirected,
                                 rng=np.random.default_rng(5))
    _equal(got, want)
    pos = set(map(tuple, ei.T.tolist()))
    assert not pos & set(map(tuple, got.T.tolist()))
    assert (got[0] != got[1]).all()


def test_batched_and_structured_negative_sampling_are_jax_stream():
    a, b = _arrays(n=12, e=30), _arrays(seed=1, n=10, e=25)
    ei = np.concatenate([a["edge_index"], b["edge_index"] + 12], 1)
    batch = np.repeat([0, 1], [12, 10])
    _equal(tutils.batched_negative_sampling(ei, batch, 9,
                                            np.random.default_rng(2)),
           jns.batched_negative_sampling(ei, batch, 9,
                                         np.random.default_rng(2)))
    _equal(tutils.structured_negative_sampling(ei, 22,
                                               np.random.default_rng(3)),
           jns.structured_negative_sampling(ei, 22,
                                            np.random.default_rng(3)))


def test_negative_sampling_without_rng_draws_unseeded():
    """``rng=None`` takes a fresh ``default_rng()``, as in JAX: valid
    negatives of the asked number, not a fixed stream."""
    ei = _arrays()["edge_index"]
    draws = [tutils.negative_sampling(ei, N, 40) for _ in range(2)]
    pos = set(map(tuple, ei.T.tolist()))
    for d in draws:
        assert d.shape == (2, 40)
        assert not pos & set(map(tuple, d.T.tolist()))
    assert not np.array_equal(draws[0], draws[1])
    i, j, k = tutils.structured_negative_sampling(ei, N)
    assert not pos & set(zip(i.tolist(), k.tolist()))


# -- graph transforms ----------------------------------------------------

def _transforms():
    return {
        "normalize": (tt.NormalizeFeatures(), jt.NormalizeFeatures()),
        "self_loops": (tt.AddSelfLoops(fill_value=0.5),
                       jt.AddSelfLoops(fill_value=0.5)),
        "drop_edge": (tt.DropEdge(0.4, seed=7), jt.DropEdge(0.4, seed=7)),
        "svd": (tt.SVDFeatureReduction(4), jt.SVDFeatureReduction(4)),
        "sign": (tt.SIGN(3), jt.SIGN(3)),
        "compose": (tt.Compose([tt.AddSelfLoops(), tt.NormalizeFeatures(),
                                tt.SIGN(2)]),
                    jt.Compose([jt.AddSelfLoops(), jt.NormalizeFeatures(),
                                jt.SIGN(2)])),
    }


@pytest.mark.parametrize("edge_attr", [False, True])
@pytest.mark.parametrize("name", sorted(_transforms()))
def test_graph_transform_matches_jax(name, edge_attr):
    keys = ("x", "edge_index", "y") + (("edge_attr",) if edge_attr else ())
    t_fn, j_fn = _transforms()[name]
    got, want = _pair(keys)
    out = t_fn(got)
    _equal(out, j_fn(want))
    assert type(out).__module__.startswith("gammagl_tpu_torch.")
    assert repr(t_fn) == repr(j_fn)
    if name == "drop_edge":  # the second call draws on, as JAX's does
        _equal(t_fn(_pair(keys)[0]), j_fn(_pair(keys)[1]))


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("neg_train", [False, True])
def test_random_link_split_matches_jax(undirected, neg_train):
    got, want = _pair()
    kw = dict(num_val=0.15, num_test=0.25, is_undirected=undirected,
              add_negative_train_samples=neg_train, neg_sampling_ratio=1.5,
              seed=4)
    out = tt.RandomLinkSplit(**kw)(got)
    _equal(out, jt.RandomLinkSplit(**kw)(want))
    assert len(out) == 3 and all(type(g) is tdata.Graph for g in out)


def test_add_metapaths_matches_jax():
    rng = np.random.default_rng(9)
    pa = np.stack([rng.integers(0, 8, 20), rng.integers(0, 5, 20)])
    pf = np.stack([rng.integers(0, 8, 12), rng.integers(0, 3, 12)])
    paths = [[("paper", "pa", "author"), ("author", "ap", "paper")],
             [("paper", "field"), ("field", "paper")]]
    out = {}
    for pkg in (tdata, jdata):
        g = pkg.HeteroGraph()
        g["paper"].num_nodes, g["author"].num_nodes = 8, 5
        g["field"].num_nodes = 3
        g[("paper", "pa", "author")].edge_index = pa
        g[("author", "ap", "paper")].edge_index = pa[::-1].copy()
        g[("paper", "to", "field")].edge_index = pf
        g[("field", "to", "paper")].edge_index = pf[::-1].copy()
        out[pkg] = g
    for drop in (False, True):
        got = tt.AddMetaPaths(paths, drop)(out[tdata])
        want = jt.AddMetaPaths(paths, drop)(out[jdata])
        _equal(got, want)
    assert got.edge_types == [("paper", "metapath_pa_ap", "paper"),
                              ("paper", "metapath_to_to", "paper")]


# -- VGAE preprocessing --------------------------------------------------

def test_vgae_preprocessing_matches_jax():
    ei = _arrays(e=90)["edge_index"]
    for seed in (0, 1):
        _equal(tt.mask_test_edges(ei, N, 0.1, 0.2, seed=seed),
               jt.mask_test_edges(ei, N, 0.1, 0.2, seed=seed))
    # the weights: the JAX package computes them with its tensor op
    # (XLA's x ** -0.5, not always the correctly rounded value), the port
    # on the host (`calc_gcn_norm_np`): they agree to a few ulp
    (gei, gw), (wei, ww) = (tt.normalize_adj_for_vgae(ei, N),
                            jt.normalize_adj_for_vgae(ei, N))
    _equal(gei, wei)
    assert gw.dtype == ww.dtype == np.float32
    np.testing.assert_allclose(gw, ww, rtol=1e-6, atol=0)
    adj = sp.random(N, N, 0.2, random_state=3, format="csr")
    _equal(tt.sparse_to_tuple(adj), jt.sparse_to_tuple(adj))
