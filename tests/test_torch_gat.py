"""The port's GATConv and GATModel against the JAX package.

One numpy parameter tree feeds both packages (the port through
`load_jax_params`); the JAX plan path runs its Pallas kernels in
interpret mode. Per-edge dropout masks are handed to both packages in
the caller's edge order and mapped into each plan's order.

Tolerances, relative to max |out| (or max |grad| of each parameter): f32
1e-5 on the COO (XLA) path and 1e-4 on the plan path (bf16x3 products in
the JAX kernels); bf16 3e-2, because the two packages round at different
points (the JAX COO path sums in bf16, the port in f32).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import gammagl_tpu.ops.pallas as jax_pallas
from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.layers.conv import GATConv as JaxGATConv
from gammagl_tpu.models import GATModel as JaxGATModel

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.layers.conv import GATConv
from gammagl_tpu_torch.models import GATModel
from gammagl_tpu_torch.serve import InferenceSession
from gammagl_tpu_torch.utils import load_jax_params

N, E, F_IN = 48, 220, 12
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _graph(seed=0):
    """Random edges plus self-loops; the last 6 nodes get only their
    self-loop."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N - 6, (2, E))
    ei = np.concatenate([ei, np.stack([np.arange(N)] * 2)], 1)
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    return x, ei


def _conv_params(rng, fan_in, H, F, concat=True):
    return {"w": (rng.normal(size=(fan_in, H * F)) * 0.4).astype(np.float32),
            "att": (rng.normal(size=(1, H, 2 * F)) * 0.4).astype(np.float32),
            "bias": (rng.normal(size=(H * F if concat else F,)) * 0.1
                     ).astype(np.float32)}


def _model_params(hidden, heads, num_class, seed=1):
    rng = np.random.default_rng(seed)
    return {"params": {
        "GATConv_0": _conv_params(rng, F_IN, heads, hidden),
        "GATConv_1": _conv_params(rng, hidden * heads, 1, num_class,
                                  concat=False)}}


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


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads,concat", [(2, True), (2, False), (1, True)])
def test_gat_conv_matches_jax(plan, dtype, heads, concat):
    x, ei = _graph()
    jdt, tdt = DTYPES[dtype]
    params = {"params": _conv_params(np.random.default_rng(2), F_IN, heads,
                                     6, concat)}
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan() if plan else None
    jconv = JaxGATConv(6, heads=heads, concat=concat, dtype=jdt)
    want = jax.jit(lambda p, x, ei: jconv.apply(p, x, ei, plan=jplan))(
        params, jnp.asarray(x), jnp.asarray(ei))
    conv = load_jax_params(GATConv(None, 6, heads=heads, concat=concat,
                                   dtype=tdt), params).eval()
    tplan = Graph(x=x, edge_index=ei).csr_plan() if plan else None
    got = conv(torch.tensor(x), torch.tensor(ei), plan=tplan)
    _check(got, want, _tol(dtype, plan))


@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gat_model_matches_jax(plan, dtype):
    x, ei = _graph(3)
    jdt, tdt = DTYPES[dtype]
    params = _model_params(4, 2, 5)
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan() if plan else None
    jmodel = JaxGATModel(hidden_dim=4, num_class=5, heads=2, dtype=jdt)
    want = jax.jit(lambda p, x, ei: jmodel.apply(p, x, ei, plan=jplan))(
        params, jnp.asarray(x), jnp.asarray(ei))
    model = load_jax_params(GATModel(4, 5, heads=2, dtype=tdt), params)
    tplan = Graph(x=x, edge_index=ei).csr_plan() if plan else None
    got = model.eval()(torch.tensor(x), torch.tensor(ei), plan=tplan)
    assert got.shape == (N, 5)
    _check(got, want, _tol(dtype, plan))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("plan", [False, True])
def test_gat_model_gradients_match_jax(plan):
    x, ei = _graph(4)
    params = _model_params(4, 2, 5, seed=5)
    y = np.random.default_rng(6).integers(0, 5, N)
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan() if plan else None
    jmodel = JaxGATModel(hidden_dim=4, num_class=5, heads=2)

    def loss(p):
        logits = jmodel.apply(p, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
        ll = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(ll, jnp.asarray(y)[:, None], 1))

    want = dict(_flat(jax.jit(jax.grad(loss))(params)["params"]))
    model = load_jax_params(GATModel(4, 5, heads=2), params).eval()
    tplan = Graph(x=x, edge_index=ei).csr_plan() if plan else None
    logits = model(torch.tensor(x), torch.tensor(ei), plan=tplan)
    torch.nn.functional.cross_entropy(logits, torch.tensor(y)).backward()
    got = {f"GATConv_{i}/{k}": p.grad
           for i, conv in enumerate(model.convs)
           for k, p in conv.flax_tree().items()}
    assert sorted(got) == sorted(want)
    for name in want:
        _check(got[name], want[name], _tol("f32", plan))


def test_attention_dropout_matches_jax_plan_path(monkeypatch):
    """In training the JAX plan path draws its mask through
    `attention_keep_mask` in its padded lane order; here it is handed the
    port's caller-order mask, carried into lane order."""
    x, ei = _graph(7)
    H = 2
    params = {"params": _conv_params(np.random.default_rng(8), F_IN, H, 6)}
    rng = np.random.default_rng(9)
    keep = (rng.random((ei.shape[1], H)) < 0.4).astype(np.float32) / 0.4
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan()
    lane_perm = np.where(jplan.valid, jplan.perm, 0)
    keep_pad = keep[lane_perm] * jplan.valid[:, None]

    def fixed_mask(key, rate, shape):
        assert shape == keep_pad.shape and rate == 0.6
        return jnp.asarray(keep_pad)

    monkeypatch.setattr(jax_pallas, "attention_keep_mask", fixed_mask)
    jconv = JaxGATConv(6, heads=H, dropout_rate=0.6)
    want = jax.jit(lambda p, x, ei: jconv.apply(
        p, x, ei, train=True, plan=jplan,
        rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x), jnp.asarray(ei))
    conv = load_jax_params(GATConv(None, 6, heads=H, dropout_rate=0.6),
                           params).train()
    tx, tei, tkeep = torch.tensor(x), torch.tensor(ei), torch.tensor(keep)
    got = conv(tx, tei, plan=Graph(x=x, edge_index=ei).csr_plan(),
               keep=tkeep)
    _check(got, want, 1e-4)
    _check(conv(tx, tei, keep=tkeep), want, 1e-4)  # the COO path


def test_training_paths_agree_under_one_generator():
    """Plan and COO paths draw the same input dropout and attention masks
    from one generator state, so their outputs and gradients agree (at
    the plan path's 1e-4: the two paths form the scores in other orders,
    and scores near 100 make exp amplify it)."""
    x, ei = _graph(10)
    graph = Graph(x=x, edge_index=ei)
    params = _model_params(4, 2, 5, seed=11)
    y = np.random.default_rng(12).integers(0, 5, N)
    results = []
    for plan in (graph.csr_plan(), None):
        model = load_jax_params(GATModel(4, 5, heads=2), params).train()
        gen = torch.Generator().manual_seed(12)
        out = model(torch.tensor(x), torch.tensor(ei), plan=plan,
                    generator=gen)
        torch.nn.functional.cross_entropy(out, torch.tensor(y)).backward()
        results.append((out, [p.grad for p in model.parameters()]))
    (out_p, grads_p), (out_c, grads_c) = results
    _check(out_p, out_c.detach(), 1e-4)
    for gp, gc in zip(grads_p, grads_c):
        _check(gp, gc, 1e-4)
    assert float((out_p == 0).float().mean()) < 0.5  # dropout, not silence


def test_session_serves_gat_with_a_plan():
    x, ei = _graph(13)
    graph = Graph(x=x, edge_index=ei)
    model = load_jax_params(GATModel(4, 5, heads=2, dtype=torch.bfloat16),
                            _model_params(4, 2, 5, seed=14))
    sess = InferenceSession(model, (x, ei), device="cpu",
                            compute_dtype=torch.bfloat16,
                            plan=graph.csr_plan())
    got = sess(x, ei)
    assert got.shape == (N, 5) and not model.training
    with torch.no_grad():
        want = model(torch.tensor(x).bfloat16(), torch.tensor(ei))
    _check(got, want, 3e-2)


def test_lazy_first_layer_and_flax_names():
    model = GATModel(4, 5, heads=2)
    x, ei = _graph(15)
    model(torch.tensor(x), torch.tensor(ei))
    assert model.convs[0].w.shape == (F_IN, 8)
    tree = model.flax_tree()
    assert list(tree) == ["GATConv_0", "GATConv_1"]
    assert sorted(tree["GATConv_1"].flax_tree()) == ["att", "bias", "w"]
    assert tree["GATConv_1"].bias.shape == (5,)
    # the flax initialiser: a unit normal cut at +-2, times 0.02
    w = GATConv(64, 64, heads=4).w.detach()
    assert float(w.abs().max()) <= 0.04 and 0.01 < float(w.std()) < 0.02
