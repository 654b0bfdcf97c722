"""Graphormer in the port (`utils/shortest_path.py`,
`layers/attention/graphormer.py`, `models/graphormer.py`) against the
JAX package's.

The distances and the bucketed spatial encodings are host numpy in both
packages and must be equal bit for bit, through scipy and through the
list BFS. The layers and the model run on the graphormer twin's graphs
(16 nodes, the twin's random dense or sparse adjacency, 8 features), with
a padded member of a batch (mask) too: outputs at 1e-5 of max |out|,
gradients in every parameter at 1e-5 of each one's max |grad|. One JAX
compile a case, cached for the module.
"""

import functools
import os.path as osp
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
from gammagl_tpu.layers import attention as ja  # noqa: E402
from gammagl_tpu.models import GraphormerModel as JaxGraphormer  # noqa
from gammagl_tpu.utils.shortest_path import (  # noqa: E402
    bucketed_spatial_encoding as jax_buckets, shortest_path as jax_sp,
    _bfs_python as jax_bfs)
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

from gammagl_tpu_torch.layers import attention as ta  # noqa: E402
from gammagl_tpu_torch.models import GraphormerModel  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params, shortest_path  # noqa
from gammagl_tpu_torch.utils.shortest_path import (  # noqa: E402
    _bfs_python, bucketed_spatial_encoding)

TOL = 1e-5
KEY = jax.random.PRNGKey(4)
HID, HEADS = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def twin_graph(rng, label, n=16):
    """The graphormer script's graph: a dense (p 0.5) or sparse (p 0.15)
    random directed adjacency, 8 normal features; (x, in-degree,
    out-degree, distances clipped at 5, edges)."""
    a = rng.random((n, n)) < (0.5 if label else 0.15)
    ei = np.stack(np.nonzero(a))
    x = rng.normal(size=(n, 8)).astype(np.float32)
    dist = jax_sp(ei, n, max_dist=5)
    ind = np.bincount(ei[1], minlength=n).astype(np.int32)
    outd = np.bincount(ei[0], minlength=n).astype(np.int32)
    return x, ind, outd, dist, ei


GRAPHS = [twin_graph(np.random.default_rng(s), s % 2) for s in range(4)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _edge_sets():
    rng = np.random.default_rng(3)
    chain = np.stack([np.arange(9), np.arange(1, 10)])
    two_parts = np.array([[0, 1, 2, 5, 6], [1, 2, 0, 6, 7]])
    return [(g[4], 16) for g in GRAPHS] + [
        (chain, 12), (two_parts, 9), (np.zeros((2, 0), np.int64), 5),
        (rng.integers(0, 30, (2, 60)), 30)]


@pytest.mark.parametrize("case", range(8))
@pytest.mark.parametrize("max_dist,clip_far", [(None, True), (3, True),
                                               (3, False), (1, True)])
def test_shortest_path_bitwise(case, max_dist, clip_far):
    ei, n = _edge_sets()[case]
    want = jax_sp(ei, n, max_dist=max_dist, clip_far=clip_far)
    got = shortest_path(ei, n, max_dist=max_dist, clip_far=clip_far)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    # the list BFS (the route without scipy) gives the same matrix
    np.testing.assert_array_equal(_bfs_python(np.asarray(ei), n),
                                  jax_bfs(np.asarray(ei), n))
    if max_dist is None:
        np.testing.assert_array_equal(_bfs_python(np.asarray(ei), n), got)


def test_bucketed_spatial_encoding_bitwise():
    graphs = [types.SimpleNamespace(edge_index=ei, num_nodes=n)
              for ei, n in _edge_sets()]
    graphs.append(types.SimpleNamespace(
        edge_index=np.stack([np.arange(40), (np.arange(40) + 1) % 41]),
        num_nodes=41))  # past the largest bucket: its own, a multiple of 8
    for buckets, max_dist in (((16, 32, 64, 128), 8), ((8, 16), 2)):
        want = jax_buckets(graphs, buckets, max_dist)
        got = bucketed_spatial_encoding(graphs, buckets, max_dist)
        assert sorted(got) == sorted(want)
        for size in want:
            assert got[size]["index"] == want[size]["index"]
            for key in ("dist", "mask"):
                assert got[size][key].dtype == want[size][key].dtype
                np.testing.assert_array_equal(got[size][key],
                                              want[size][key])


def _mask(n=16, real=11):
    m = np.zeros(n, bool)
    m[:real] = True
    return m


def _cases():
    x, ind, outd, dist, _ = GRAPHS[1]
    h = _cot((16, HID), 3)
    bias = _cot((16, 16, HEADS), 4)
    eattr = _cot((16, 16, 5), 5)
    mask = _mask()
    return {
        "centrality": (ja.CentralityEncoder(6, HID), (h, ind, outd),
                       ta.CentralityEncoder(6, HID), (16, HID)),
        "spatial": (ja.SpatialEncoder(3, HEADS), (dist,),
                    ta.SpatialEncoder(3, HEADS), (16, 16, HEADS)),
        "edge": (ja.EdgeEncoder(HEADS), (eattr,),
                 ta.EdgeEncoder(HEADS), (16, 16, HEADS)),
        "layer": (ja.GraphormerLayer(HID, HEADS), (h,),
                  ta.GraphormerLayer(HID, HEADS), (16, HID)),
        "layer_bias_mask": (ja.GraphormerLayer(HID, HEADS, ffn_dim=24),
                            (h, bias, mask),
                            ta.GraphormerLayer(HID, HEADS, ffn_dim=24),
                            (16, HID)),
        "model": (JaxGraphormer(HID, 2, num_layers=2, num_heads=HEADS,
                                dropout_rate=0.0), (x, ind, outd, dist),
                  GraphormerModel(HID, 2, num_layers=2, num_heads=HEADS,
                                  dropout_rate=0.0), (2,)),
        "model_masked": (JaxGraphormer(HID, 3, num_layers=2, num_heads=4,
                                       max_degree=4, max_dist=2),
                         (x, ind, outd, dist, mask),
                         GraphormerModel(HID, 3, num_layers=2, num_heads=4,
                                         max_degree=4, max_dist=2), (3,)),
    }


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    jmod, jin, _, shape = CASES[name]
    jin = tuple(jnp.asarray(a) for a in jin)
    params = jax.jit(jmod.init)(KEY, *jin)
    g = _cot(shape, 11)

    def loss(p):
        out = jmod.apply(p, *jin)
        return jnp.sum(out * g), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return _np_tree(params), np.asarray(out), grads, g


@pytest.mark.parametrize("name", sorted(CASES))
def test_graphormer_parts_match_jax(name):
    _, jin, tmod, _ = CASES[name]
    params, want, grads, g = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    out = model(*(_t(a) for a in jin))
    (out * _t(g)).sum().backward()
    _check(out, want, TOL)
    _check_grads(model, grads, TOL)


def test_graphormer_on_every_twin_graph():
    """One parameter tree, the twin's four graphs (two dense, two
    sparse): the logits at 1e-5."""
    jmodel = JaxGraphormer(32, 2, num_layers=2, num_heads=2,
                           dropout_rate=0.0)
    x, ind, outd, dist, _ = GRAPHS[0]
    params = jax.jit(jmodel.init)(KEY, x, ind, outd, dist)
    apply = jax.jit(jmodel.apply)
    model = load_jax_params(
        GraphormerModel(32, 2, num_layers=2, num_heads=2, dropout_rate=0.0),
        _np_tree(params)).eval()
    for x, ind, outd, dist, _ in GRAPHS:
        want = apply(params, x, ind, outd, dist)
        with torch.no_grad():
            got = model(_t(x), _t(ind), _t(outd), _t(dist))
        _check(got, want, TOL)


def test_init_laws_and_training_dropout():
    """The port's own init: embeddings normal with variance 1 / width,
    as flax's ``Embed``; LayerNorm epsilon 1e-6. In training mode the
    dropout draws from the generator: two equal generators give equal
    outputs, and a rate of 0 gives the eval forward."""
    torch.manual_seed(0)
    enc = ta.CentralityEncoder(400, 64)
    assert abs(float(enc.z_in.weight.detach().std()) - 1 / 8) < 5e-3
    layer = ta.GraphormerLayer(HID, HEADS)
    assert layer.norm0.eps == 1e-6
    h = _t(_cot((16, HID), 3))
    outs = [layer.train()(h, generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(*outs)
    layer0 = ta.GraphormerLayer(HID, HEADS, dropout_rate=0.0)
    with torch.no_grad():
        assert torch.equal(layer0.train()(h), layer0.eval()(h))
