"""The port's SAGEConv, GraphSAGEModel and GraphSAGESampleModel against the
JAX package.

One numpy parameter tree feeds both (the port through `load_jax_params`).
With a plan the JAX layer runs its Pallas kernels in interpret mode for
'mean' and 'gcn' and drops the plan for 'pool' and 'max' (ROADMAP C4);
the port runs its plain versions of the SpMM and segment-max kernels.

Tolerances, relative to max |out|: f32 1e-5 without a plan (XLA) and 1e-4
with one (bf16x3 products in the JAX kernels); bf16 3e-2, because the two
packages round at different points. Degrees stay under 256, where the JAX
layer's bf16 counts are exact (ROADMAP C1).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.layers.conv import SAGEConv as JaxSAGEConv
from gammagl_tpu.models import GraphSAGEModel as JaxGraphSAGEModel
from gammagl_tpu.models import GraphSAGESampleModel as JaxSampleModel
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan

from gammagl_tpu_torch.layers.conv import SAGEConv
from gammagl_tpu_torch.models import GraphSAGEModel, GraphSAGESampleModel
from gammagl_tpu_torch.ops import cuda as k
from gammagl_tpu_torch.utils import load_jax_params

N, E, F_IN = 50, 240, 10
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
AGGRS = ["mean", "gcn", "pool", "max"]


def _graph(seed=0, n_src=N, n_dst=N):
    """Random edges; the last 5 destination rows get none."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n_src, E), rng.integers(0, n_dst - 5, E)])
    x = rng.normal(size=(n_src, F_IN)).astype(np.float32)
    return x, ei


def _conv_params(rng, aggr, fan_src, fan_dst, out):
    """The JAX layer's tree: Dense_0 neighbour map, Dense_1 the pool map
    (pool/max), then the self map (not for gcn), and the bias."""
    dense = [(fan_src, out)]
    if aggr in ("pool", "max"):
        dense.append((fan_src, fan_src))
    if aggr != "gcn":
        dense.append((fan_dst, out))
    tree = {f"Dense_{i}": {"kernel": (rng.normal(size=s) * 0.4).astype(
        np.float32)} for i, s in enumerate(dense)}
    tree["bias"] = (rng.normal(size=out) * 0.1).astype(np.float32)
    return tree


def _check(got, want, tol):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _tol(dtype, plan):
    if dtype == "bf16":
        return 3e-2
    return 1e-4 if plan else 1e-5


@pytest.mark.parametrize("plan,dtype", [(False, "f32"), (False, "bf16"),
                                        (True, "f32"), (True, "bf16")])
@pytest.mark.parametrize("aggr", AGGRS)
def test_sage_conv_matches_jax(aggr, plan, dtype):
    x, ei = _graph()
    jdt, tdt = DTYPES[dtype]
    params = {"params": _conv_params(np.random.default_rng(1), aggr, F_IN,
                                     F_IN, 6)}
    jplan = (jax_build_csr_plan(ei[0], ei[1], N, R=8, ET=32, window=True)
             if plan else None)
    tplan = k.build_csr_plan(ei[0], ei[1], N, window=True) if plan else None
    jconv = JaxSAGEConv(6, aggr=aggr, dtype=jdt)
    want = jax.jit(lambda p, x, ei: jconv.apply(p, x, ei, plan=jplan))(
        params, jnp.asarray(x), jnp.asarray(ei))
    conv = load_jax_params(SAGEConv(None, 6, aggr=aggr, dtype=tdt), params)
    got = conv(torch.tensor(x), torch.tensor(ei), plan=tplan)
    _check(got, want, _tol(dtype, plan))


@pytest.mark.parametrize("aggr", AGGRS)
def test_bipartite_inputs_match_jax(aggr):
    """(x_src, x_dst) of different sizes and widths, with a plan whose
    sources outnumber its destinations."""
    rng = np.random.default_rng(2)
    x_src = rng.normal(size=(60, F_IN)).astype(np.float32)
    x_dst = rng.normal(size=(N, 7)).astype(np.float32)
    ei = np.stack([rng.integers(0, 60, E), rng.integers(0, N - 5, E)])
    params = {"params": _conv_params(rng, aggr, F_IN, 7, 6)}
    jconv = JaxSAGEConv(6, aggr=aggr)
    want = jconv.apply(params, (jnp.asarray(x_src), jnp.asarray(x_dst)),
                       jnp.asarray(ei))
    conv = load_jax_params(SAGEConv((F_IN, 7), 6, aggr=aggr), params)
    plan = k.build_csr_plan(ei[0], ei[1], N, num_src=60)
    feat = (torch.tensor(x_src), torch.tensor(x_dst))
    for p in (None, plan):
        _check(conv(feat, torch.tensor(ei), plan=p), want, 1e-5)


@pytest.mark.parametrize("aggr", ["pool", "max"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pool_routes_are_equal(aggr, dtype):
    """ROADMAP C4: the JAX layer drops its plan on the pool/max branch; the
    port passes it to the segment-max kernel. A max is exact in any order,
    so the plan route, the COO route and the JAX layer (given its plan)
    agree bit for bit before the last linear maps, and the whole layer
    agrees within the dtype's tolerance."""
    x, ei = _graph(3)
    jdt, tdt = DTYPES[dtype]
    params = {"params": _conv_params(np.random.default_rng(4), aggr, F_IN,
                                     F_IN, 6)}
    conv = load_jax_params(SAGEConv(None, 6, aggr=aggr, dtype=tdt), params)
    tx, tei = torch.tensor(x), torch.tensor(ei)
    plan = k.build_csr_plan(ei[0], ei[1], N, window=True)
    before = k.spmm_max_csr.launches
    h = torch.relu(conv._dense(conv.lin_pool, tx, tdt))
    on_plan = conv.propagate(h, tei, aggr="max", plan=plan)
    on_coo = conv.propagate(h, tei, aggr="max")
    assert torch.equal(on_plan, on_coo) and on_plan.dtype == h.dtype
    assert k.spmm_max_csr.launches == before  # plain versions on the CPU
    jplan = jax_build_csr_plan(ei[0], ei[1], N, R=8, ET=32, window=True)
    want = JaxSAGEConv(6, aggr=aggr, dtype=jdt).apply(
        params, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
    got = conv(tx, tei, plan=plan)
    assert torch.equal(got, conv(tx, tei))
    _check(got, want, _tol(dtype, False))


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("aggr", ["mean", "pool"])
def test_graphsage_model_matches_jax(aggr, plan):
    x, ei = _graph(5)
    rng = np.random.default_rng(6)
    params = {"params": {
        "SAGEConv_0": _conv_params(rng, aggr, F_IN, F_IN, 8),
        "SAGEConv_1": _conv_params(rng, aggr, 8, 8, 8),
        "SAGEConv_2": _conv_params(rng, aggr, 8, 8, 4)}}
    jplan = (jax_build_csr_plan(ei[0], ei[1], N, R=8, ET=32, window=True)
             if plan else None)
    jmodel = JaxGraphSAGEModel(hidden_dim=8, num_class=4, num_layers=3,
                               aggr=aggr)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
    model = load_jax_params(GraphSAGEModel(8, 4, num_layers=3, aggr=aggr),
                            params).eval()
    got = model(torch.tensor(x), torch.tensor(ei),
                plan=k.build_csr_plan(ei[0], ei[1], N) if plan else None)
    assert got.shape == (N, 4)
    _check(got, want, _tol("f32", plan))


@pytest.mark.parametrize("aggr", ["mean", "gcn", "max"])
def test_sampled_model_matches_jax(aggr):
    """Two hand-made bipartite blocks, outermost hop first: 40 -> 20 -> 8
    nodes, the first rows of each layer's input its destinations."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, F_IN)).astype(np.float32)
    adjs = [(np.stack([rng.integers(0, 40, 120), rng.integers(0, 20, 120)]),
             20),
            (np.stack([rng.integers(0, 20, 50), rng.integers(0, 8, 50)]), 8)]
    params = {"params": {
        "SAGEConv_0": _conv_params(rng, aggr, F_IN, F_IN, 6),
        "SAGEConv_1": _conv_params(rng, aggr, 6, 6, 3)}}
    jmodel = JaxSampleModel(hidden_dim=6, num_class=3, num_layers=2,
                            aggr=aggr)
    want = jmodel.apply(params, jnp.asarray(x),
                        [(jnp.asarray(e), n) for e, n in adjs])
    model = load_jax_params(GraphSAGESampleModel(6, 3, aggr=aggr),
                            params).eval()
    got = model(torch.tensor(x), [(torch.tensor(e), n) for e, n in adjs])
    assert got.shape == (8, 3)
    _check(got, want, 1e-5)


def test_flax_names_and_own_init():
    tree = SAGEConv(None, 6, aggr="pool").flax_tree()
    assert sorted(tree) == ["Dense_0", "Dense_1", "Dense_2", "bias"]
    assert sorted(SAGEConv(None, 6, aggr="gcn").flax_tree()) == [
        "Dense_0", "bias"]
    model = GraphSAGEModel(16, 4, num_layers=3, aggr="max")
    assert list(model.flax_tree()) == ["SAGEConv_0", "SAGEConv_1",
                                       "SAGEConv_2"]
    x, ei = _graph(8)
    out = model.eval()(torch.tensor(x), torch.tensor(ei))  # lazy first layer
    conv = model.convs[0]
    assert out.shape == (N, 4) and conv.lin_pool.weight.shape == (F_IN, F_IN)
    assert conv.lin_neigh.weight.shape == (16, F_IN)
    # he-normal kernels: variance 2 / fan_in, cut at 2 standard deviations
    w = model.convs[1].lin_pool.weight.detach()
    std = np.sqrt(2.0 / 16)
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert bool((model.convs[1].bias == 0).all())
