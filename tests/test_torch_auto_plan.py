"""The port's node orderings, `Graph.auto_plan` and the block-pair route
through the layers, the model, the session and the trainer loop, against
the JAX package.

The orderings are host numpy in both packages and must agree bit for bit;
`auto_plan` must pick the same kind of plan for the same graph (the
generators of `tests/ops/test_auto_plan.py`). The layers and models run
the port's plain versions on the CPU against the JAX layers given the JAX
plan (Pallas kernels, interpreted off-TPU).

Tolerances, of max |out|: f32 1e-4 (the Pallas f32 path's bf16 split);
bf16 3e-2 (the JAX bf16 path rounds messages and weights to bf16);
loss curves rtol 1e-4, as the twins' tests.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.layers.conv import GCNConv as JaxGCNConv
from gammagl_tpu.layers.conv import SAGEConv as JaxSAGEConv
from gammagl_tpu.models import GCNModel as JaxGCNModel
from gammagl_tpu.ops.pallas import BlockPairPlan as JaxBlockPairPlan
from gammagl_tpu.ops.pallas import CSRPlan as JaxCSRPlan
from gammagl_tpu.ops.pallas import HybridPlan as JaxHybridPlan
from gammagl_tpu.parallel.halo import reorder_bandwidth as jax_rcm
from gammagl_tpu.parallel.partition import cluster_permutation as jax_lp
from gammagl_tpu.train import TrainState as JaxTrainState
from gammagl_tpu.train import semi_supervised_loss as jax_loss
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.examples import common
from gammagl_tpu_torch.layers.conv import GCNConv, SAGEConv
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.ops import cuda as kops
from gammagl_tpu_torch.parallel import cluster_permutation, reorder_bandwidth
from gammagl_tpu_torch.serve import InferenceSession
from gammagl_tpu_torch.utils import add_self_loops, load_jax_params


def _banded(n=4096, band=64, e=32000, seed=0, scramble=False):
    """tests/ops/test_auto_plan.py's banded graph (clip, not mod)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-band, band + 1, e), 0, n - 1)
    if scramble:
        p = rng.permutation(n)
        src, dst = p[src], p[dst]
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return x, np.stack([src, dst])


def _random(n=2000, e=6000):
    rng = np.random.default_rng(1)
    return (rng.normal(size=(n, 4)).astype(np.float32),
            np.stack([rng.integers(0, n, e), rng.integers(0, n, e)]))


def _mixed(n=8192, per=6000, tail=8000, seed=9):
    """Dense 256x256 diagonal windows and a scattered tail."""
    rng = np.random.default_rng(seed)
    sd, dd = [], []
    for b in range(n // 256):
        sd.append(b * 256 + rng.integers(0, 256, per))
        dd.append(b * 256 + rng.integers(0, 256, per))
    sd.append(rng.integers(0, n, tail))
    dd.append(rng.integers(0, n, tail))
    return (rng.normal(size=(n, 8)).astype(np.float32),
            np.stack([np.concatenate(sd), np.concatenate(dd)]))


def _sbm_scrambled(n=16384, k=32, seed=0):
    """tests/ops/test_auto_plan.py's clustered graph with scrambled ids."""
    rng = np.random.default_rng(seed)
    size = n // k
    src_parts, dst_parts = [], []
    for c in range(k):
        src_parts.append(c * size + rng.integers(0, size, 3072))
        dst_parts.append(c * size + rng.integers(0, size, 3072))
    src_parts.append(rng.integers(0, n, n // 4))
    dst_parts.append(rng.integers(0, n, n // 4))
    p = rng.permutation(n)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return x, np.stack([p[np.concatenate(src_parts)],
                        p[np.concatenate(dst_parts)]])


KINDS = {kops.BlockPairPlan: JaxBlockPairPlan, kops.HybridPlan: JaxHybridPlan,
         kops.CSRPlan: JaxCSRPlan}


@pytest.mark.parametrize("name,make,kind", [
    ("banded", _banded, kops.BlockPairPlan),
    ("random", _random, kops.CSRPlan),
    ("scrambled", lambda: _banded(scramble=True), kops.CSRPlan),
    ("mixed", _mixed, kops.HybridPlan)])
def test_auto_plan_picks_the_jax_kind(name, make, kind):
    x, ei = make()
    plan = Graph(x=x, edge_index=ei).auto_plan()
    jplan = JaxGraph(x=x, edge_index=ei).auto_plan()
    assert isinstance(plan, kind), plan
    assert isinstance(jplan, KINDS[kind]), jplan
    if kind is kops.BlockPairPlan:
        assert plan.fill_ratio == jplan.fill_ratio >= 0.8
        assert (plan.E_pad, plan.T) == (jplan.E_pad, jplan.T)
    if kind is kops.HybridPlan:
        assert plan.dense_frac == jplan.dense_frac >= 0.25


def test_auto_plan_is_cached_per_tiling_and_not_shared_by_clones():
    x, ei = _banded()
    g = Graph(x=x, edge_index=ei)
    plan = g.auto_plan()
    assert g.auto_plan() is plan
    other = g.auto_plan(R=128, S=128, ET=128)
    assert other is not plan and other.R == 128
    assert g.auto_plan(R=128, S=128, ET=128) is other
    assert g.clone().auto_plan() is not plan
    assert Graph(x=x, edge_index=ei).block_pair_fill() == (
        JaxGraph(x=x, edge_index=ei).block_pair_fill())


def test_orderings_are_the_jax_permutations():
    x, ei = _banded(n=1500, e=9000, scramble=True)
    for port, ref in ((reorder_bandwidth(ei, 1500), jax_rcm(ei, 1500)),
                      (cluster_permutation(ei, 1500, rounds=5),
                       jax_lp(ei, 1500, rounds=5))):
        for a, b in zip(port, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["reorder_rcm", "reorder_cluster"])
def test_graph_reorderings_match_jax(method):
    x, ei = _banded(n=2048, e=16000, scramble=True)
    y = np.arange(2048) % 7
    g2, perm = getattr(Graph(x=x, edge_index=ei, y=y), method)()
    j2, jperm = getattr(JaxGraph(x=x, edge_index=ei, y=y), method)()
    np.testing.assert_array_equal(perm, jperm)
    for key in ("x", "edge_index", "y"):
        np.testing.assert_array_equal(np.asarray(getattr(g2, key)),
                                      np.asarray(getattr(j2, key)))
    np.testing.assert_array_equal(g2.x, x[perm])
    # tensors are permuted as tensors
    t2, _ = getattr(Graph(x=torch.from_numpy(x), edge_index=ei), method)()
    assert isinstance(t2.x, torch.Tensor)
    np.testing.assert_array_equal(t2.x.numpy(), x[perm])


def test_reorder_rcm_recovers_banding():
    x, ei = _banded(scramble=True)
    g = Graph(x=x, edge_index=ei)
    assert not isinstance(g.auto_plan(), kops.BlockPairPlan)
    g2, perm = g.reorder_rcm()
    np.testing.assert_array_equal(g2.x, x[perm])
    plan = g2.auto_plan()
    assert isinstance(plan, kops.BlockPairPlan), plan
    jplan = JaxGraph(x=x, edge_index=ei).reorder_rcm()[0].auto_plan()
    assert isinstance(jplan, JaxBlockPairPlan)
    assert plan.fill_ratio == jplan.fill_ratio


@pytest.mark.parametrize("name,make,tiling", [
    ("sbm", _sbm_scrambled, dict(R=128, S=128, ET=128)),
    ("banded", lambda: _banded(scramble=True), {})])
def test_reorder_best_matches_jax(name, make, tiling):
    x, ei = make()
    g2, perm, got_name, fill = Graph(x=x, edge_index=ei).reorder_best(
        **tiling)
    j2, jperm, want_name, jfill = JaxGraph(x=x, edge_index=ei).reorder_best(
        **tiling)
    assert (got_name, fill) == (want_name, jfill)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(np.asarray(g2.edge_index),
                                  np.asarray(j2.edge_index))
    if name == "sbm":
        assert got_name == "cluster"


def _plans(kind):
    """(x, edge_index, port plan, JAX plan) of a small graph whose auto
    plan is ``kind`` (in-degrees under 256, see tests/test_torch_gcn.py)."""
    if kind == "block_pair":
        x, ei = _banded(n=512, band=8, e=4000, seed=3)
        tiling = dict(R=32, S=32, ET=32)
    else:
        x, ei = _mixed(n=1024, per=700, tail=800, seed=4)
        tiling = dict(R=256, S=256, ET=256)
    plan = Graph(x=x, edge_index=ei).auto_plan(**tiling)
    jplan = JaxGraph(x=x, edge_index=ei).auto_plan(**tiling)
    want = kops.BlockPairPlan if kind == "block_pair" else kops.HybridPlan
    assert isinstance(plan, want) and isinstance(jplan, KINDS[want])
    return x, ei, plan, jplan


def _dense(rng, fan_in, fan_out):
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return {"Dense_0": {"kernel": rng.uniform(-lim, lim, (fan_in, fan_out))
                        .astype(np.float32)},
            "bias": rng.uniform(-0.5, 0.5, fan_out).astype(np.float32)}


def _check(got, want, tol):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("kind", ["block_pair", "hybrid"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gcn_conv_with_auto_plan_matches_jax(kind, dtype):
    x, ei, plan, jplan = _plans(kind)
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = {"params": _dense(np.random.default_rng(2), 8, 16)}
    want = JaxGCNConv(16, dtype=jdt).apply(params, jnp.asarray(x),
                                           jnp.asarray(ei), plan=jplan)
    conv = load_jax_params(GCNConv(8, 16, dtype=tdt), params)
    got = conv(torch.from_numpy(x), torch.from_numpy(ei), plan=plan)
    _check(got, want, 1e-4 if dtype == "f32" else 3e-2)
    # the plan route equals the port's COO route
    _check(got, conv(torch.from_numpy(x), torch.from_numpy(ei)).detach(),
           1e-5 if dtype == "f32" else 2e-2)


@pytest.mark.parametrize("kind", ["block_pair", "hybrid"])
@pytest.mark.parametrize("aggr", ["mean", "gcn", "pool"])
def test_sage_conv_with_auto_plan_matches_jax(kind, aggr, monkeypatch):
    """mean and gcn take the block-pair (and CSR) kernels; pool's max takes
    the COO route in both packages (the JAX layer drops its plan there;
    the port's MessagePassing sends a block-pair plan's max to COO)."""
    x, ei, plan, jplan = _plans(kind)
    jconv = JaxSAGEConv(12, aggr=aggr)
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(ei))
    params = jax.tree_util.tree_map(np.asarray, params)
    want = jconv.apply(params, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
    conv = load_jax_params(SAGEConv(8, 12, aggr=aggr), params)
    if aggr == "pool":
        import gammagl_tpu_torch.layers.conv.message_passing as mp

        def refuse(*a, **k):
            raise AssertionError("a block-pair plan reached spmm_max_csr")
        monkeypatch.setattr(mp, "spmm_max_csr", refuse)
    got = conv(torch.from_numpy(x), torch.from_numpy(ei), plan=plan)
    _check(got, want, 1e-4)
    coo = conv(torch.from_numpy(x), torch.from_numpy(ei))
    if aggr == "pool":
        assert torch.equal(got, coo)


@pytest.mark.parametrize("kind", ["block_pair", "hybrid"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gcn_model_session_with_auto_plan_matches_jax(kind, dtype):
    """A 3-layer GCNModel served by the port's InferenceSession on the CPU
    with `auto_plan()`, against JAX GCNModel.apply with the JAX
    `auto_plan()`, on the graph with self-loops."""
    x, ei = (_banded(n=512, band=8, e=4000, seed=3) if kind == "block_pair"
             else _mixed(n=1024, per=700, tail=800, seed=4))
    tiling = (dict(R=32, S=32, ET=32) if kind == "block_pair" else {})
    g = Graph(x=x, edge_index=ei).add_self_loop()
    jg = JaxGraph(x=x, edge_index=ei).add_self_loop()
    ei = np.asarray(g.edge_index)
    np.testing.assert_array_equal(ei, np.asarray(jg.edge_index))
    plan, jplan = g.auto_plan(**tiling), jg.auto_plan(**tiling)
    want = kops.BlockPairPlan if kind == "block_pair" else kops.HybridPlan
    assert isinstance(plan, want) and isinstance(jplan, KINDS[want])
    jdt, tdt = {"f32": (None, None),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel = JaxGCNModel(hidden_dim=32, num_class=5, num_layers=3, dtype=jdt)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         jnp.asarray(ei))
    params = jax.tree_util.tree_map(np.asarray, params)
    want = jmodel.apply(params, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
    model = load_jax_params(GCNModel(hidden_dim=32, num_class=5,
                                     num_layers=3, dtype=tdt), params)
    sess = InferenceSession(model, (x, ei), device="cpu",
                            compute_dtype=tdt, plan=plan)
    got = sess(x, ei)
    assert got.shape == (x.shape[0], 5)
    _check(got, want, 1e-4 if dtype == "f32" else 3e-2)


def test_trainer_loop_with_block_pair_plan_follows_jax():
    """`run_simple_node_trainer` handed a `BlockPairPlan` (dropout off,
    f32, the JAX trainer's step on the JAX `auto_plan()`): 5 losses."""
    rng = np.random.default_rng(8)
    n, band, e = 256, 4, 1500
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-band, band + 1, e), 0, n - 1)
    y = (np.arange(n) // 64).astype(np.int64)
    data = {"x": (rng.normal(size=(n, 12)) + np.eye(4, 12)[y]).astype(
        np.float32), "edge_index": np.stack([src, dst]), "y": y}
    for name, frac in (("train_mask", 0.5), ("val_mask", 0.25),
                       ("test_mask", 0.25)):
        data[name] = rng.random(n) < frac
    ei, _ = add_self_loops(data["edge_index"], num_nodes=n)
    plan = Graph(edge_index=ei, num_nodes=n).auto_plan(R=16, S=16, ET=16)
    assert isinstance(plan, kops.BlockPairPlan), plan
    jei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    np.testing.assert_array_equal(ei, np.asarray(jei))
    jplan = JaxGraph(edge_index=np.asarray(jei),
                     num_nodes=n).auto_plan(R=16, S=16, ET=16)
    assert isinstance(jplan, JaxBlockPairPlan)

    args = common.base_parser(hidden_dim=8, n_epoch=5, drop_rate=0.0).\
        parse_args(["--device", "cpu"])
    model = JaxGCNModel(hidden_dim=8, num_class=4, drop_rate=0.0)
    x, jy = jnp.asarray(data["x"]), jnp.asarray(y)
    mask = jnp.asarray(data["train_mask"])
    params = model.init(jax.random.PRNGKey(0), x, jnp.asarray(jei))
    tx = optax.chain(optax.add_decayed_weights(args.l2_coef),
                     optax.adam(args.lr))
    state = JaxTrainState.create(params=params, tx=tx)

    @jax.jit
    def step(state):
        loss, grads = jax.value_and_grad(lambda p: jax_loss(model.apply(
            p, x, jnp.asarray(jei), train=True, plan=jplan), jy,
            mask))(state.params)
        return state.apply_gradients(grads), loss

    want = []
    for _ in range(5):
        state, loss = step(state)
        want.append(float(loss))
    got = common.run_simple_node_trainer(
        GCNModel(hidden_dim=8, num_class=4, drop_rate=0.0), args, data=data,
        params=jax.tree_util.tree_map(np.asarray, params),
        forward_kwargs={"plan": plan})
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
