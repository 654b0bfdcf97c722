"""The port's GATV2Conv and GATV2Model against the JAX package.

One numpy parameter tree feeds both packages (the port through
`load_jax_params`). The JAX plan path runs its Pallas kernels in interpret
mode, on window plans (`Graph.csr_plan()`'s default: compact gathers and
`_expand_kernel_win`) and on padded plans. Per-edge dropout masks are
handed to both packages in the caller's edge order and mapped into each
plan's order.

Tolerances, relative to max |out| (or max |grad| of each parameter): f32
1e-5 on the COO (XLA) path and 1e-4 on the plan path (bf16x3 products in
the JAX kernels); bf16 3e-2, because the two packages round at different
points.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import gammagl_tpu.ops.pallas as jax_pallas
from gammagl_tpu.layers.conv import GATV2Conv as JaxGATV2Conv
from gammagl_tpu.models import GATV2Model as JaxGATV2Model
from gammagl_tpu.ops.pallas import build_csr_plan as jax_build_csr_plan
from gammagl_tpu.utils.compute_dtype import compute_dtype as jax_compute_dtype

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.layers.conv import GATV2Conv
from gammagl_tpu_torch.models import GATV2Model
from gammagl_tpu_torch.serve import InferenceSession
from gammagl_tpu_torch.utils import compute_dtype, load_jax_params

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


def _plans(x, ei, plan):
    """(JAX plan, port plan) for plan in {"coo", "window", "padded"}."""
    if plan == "coo":
        return None, None
    jplan = jax_build_csr_plan(ei[0], ei[1], N, R=8, ET=32,
                               window=plan == "window")
    return jplan, Graph(x=x, edge_index=ei).csr_plan()


def _conv_params(rng, fan_in, H, F, concat=True, share=False):
    """Attention vectors large enough that the softmax is not uniform."""
    dense = {"kernel": (rng.normal(size=(fan_in, H * F)) * 0.4
                        ).astype(np.float32)}
    tree = {"Dense_0": dense,
            "att": (rng.normal(size=(1, H, F)) * 0.6).astype(np.float32),
            "bias": (rng.normal(size=(H * F if concat else F,)) * 0.1
                     ).astype(np.float32)}
    if not share:
        tree["Dense_1"] = {"kernel": (rng.normal(size=(fan_in, H * F)) * 0.4
                                      ).astype(np.float32)}
    return tree


def _model_params(hidden, heads, num_class, seed=1):
    rng = np.random.default_rng(seed)
    return {"params": {
        "GATV2Conv_0": _conv_params(rng, F_IN, heads, hidden),
        "GATV2Conv_1": _conv_params(rng, hidden * heads, 1, num_class,
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
    return 1e-5 if plan == "coo" else 1e-4


@pytest.mark.parametrize("plan,dtype", [
    ("coo", "f32"), ("coo", "bf16"), ("window", "f32"), ("window", "bf16"),
    ("padded", "f32")])
@pytest.mark.parametrize("heads,concat,share", [
    (2, True, False), (2, False, False), (2, True, True)])
def test_gatv2_conv_matches_jax(plan, dtype, heads, concat, share):
    x, ei = _graph()
    jdt, tdt = DTYPES[dtype]
    params = {"params": _conv_params(np.random.default_rng(2), F_IN, heads,
                                     6, concat, share)}
    jplan, tplan = _plans(x, ei, plan)
    jconv = JaxGATV2Conv(6, heads=heads, concat=concat, share_weights=share,
                         dtype=jdt)
    want = jax.jit(lambda p, x, ei: jconv.apply(p, x, ei, plan=jplan))(
        params, jnp.asarray(x), jnp.asarray(ei))
    conv = load_jax_params(GATV2Conv(None, 6, heads=heads, concat=concat,
                                     share_weights=share, dtype=tdt),
                           params).eval()
    got = conv(torch.tensor(x), torch.tensor(ei), plan=tplan)
    _check(got, want, _tol(dtype, plan))


@pytest.mark.parametrize("plan", ["coo", "window"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gatv2_model_matches_jax(plan, dtype):
    """GATV2Model has no dtype: both packages compute in the process
    default (`compute_dtype`)."""
    x, ei = _graph(3)
    jdt, tdt = DTYPES[dtype]
    params = _model_params(4, 2, 5)
    jplan, tplan = _plans(x, ei, plan)
    jmodel = JaxGATV2Model(hidden_dim=4, num_class=5, heads=2)
    with jax_compute_dtype(jdt):
        want = jax.jit(lambda p, x, ei: jmodel.apply(p, x, ei, plan=jplan))(
            params, jnp.asarray(x), jnp.asarray(ei))
    model = load_jax_params(GATV2Model(4, 5, heads=2), params).eval()
    with compute_dtype(tdt):
        got = model(torch.tensor(x), torch.tensor(ei), plan=tplan)
    assert got.shape == (N, 5)
    _check(got, want, _tol(dtype, plan))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("plan", ["coo", "window", "padded"])
def test_gatv2_model_gradients_match_jax(plan):
    """Step-0 gradients of every parameter, f32, against jax.grad."""
    x, ei = _graph(4)
    params = _model_params(4, 2, 5, seed=5)
    y = np.random.default_rng(6).integers(0, 5, N)
    jplan, tplan = _plans(x, ei, plan)
    jmodel = JaxGATV2Model(hidden_dim=4, num_class=5, heads=2)

    def loss(p):
        logits = jmodel.apply(p, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
        ll = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(ll, jnp.asarray(y)[:, None], 1))

    want = dict(_flat(jax.jit(jax.grad(loss))(params)["params"]))
    model = load_jax_params(GATV2Model(4, 5, heads=2), params).eval()
    logits = model(torch.tensor(x), torch.tensor(ei), plan=tplan)
    torch.nn.functional.cross_entropy(logits, torch.tensor(y)).backward()
    got = {}
    for i, conv in enumerate(model.convs):
        for k, p in conv.flax_tree().items():
            if isinstance(p, torch.nn.Linear):  # kernel = weight.T
                got[f"GATV2Conv_{i}/{k}/kernel"] = p.weight.grad.T
            else:
                got[f"GATV2Conv_{i}/{k}"] = p.grad
    assert sorted(got) == sorted(want)
    for name in want:
        _check(got[name], want[name], _tol("f32", plan))


@pytest.mark.parametrize("window", [False, True])
def test_attention_dropout_matches_jax_plan_path(monkeypatch, window):
    """``keep`` in the caller's edge order, on both port paths, against
    the JAX plan path handed the same mask in its lane order."""
    x, ei = _graph(7)
    H = 2
    params = {"params": _conv_params(np.random.default_rng(8), F_IN, H, 6)}
    rng = np.random.default_rng(9)
    keep = (rng.random((ei.shape[1], H)) < 0.4).astype(np.float32) / 0.4
    jplan = jax_build_csr_plan(ei[0], ei[1], N, R=8, ET=32, window=window)
    lane_perm = np.where(jplan.valid, jplan.perm, 0)
    keep_pad = keep[lane_perm] * jplan.valid[:, None]

    def fixed_mask(key, rate, shape):
        assert shape == keep_pad.shape and rate == 0.6
        return jnp.asarray(keep_pad)

    monkeypatch.setattr(jax_pallas, "attention_keep_mask", fixed_mask)
    jconv = JaxGATV2Conv(6, heads=H, dropout_rate=0.6)
    want = jax.jit(lambda p, x, ei: jconv.apply(
        p, x, ei, train=True, plan=jplan,
        rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(x), jnp.asarray(ei))
    conv = load_jax_params(GATV2Conv(None, 6, heads=H, dropout_rate=0.6),
                           params).train()
    tx, tei, tkeep = torch.tensor(x), torch.tensor(ei), torch.tensor(keep)
    got = conv(tx, tei, plan=Graph(x=x, edge_index=ei).csr_plan(),
               keep=tkeep)
    _check(got, want, 1e-4)
    _check(conv(tx, tei, keep=tkeep), want, 1e-4)  # the COO path


def test_drawn_masks_are_in_csr_order_on_both_paths():
    """A mask drawn from a generator is drawn in the plan's CSR order: the
    plan path reads it as drawn, the COO path scatters it into edge
    order, so one generator state gives both paths the same mask."""
    x, ei = _graph(16)
    plan = Graph(x=x, edge_index=ei).csr_plan()
    conv = GATV2Conv(F_IN, 4, heads=3, dropout_rate=0.5).train()
    tei = torch.tensor(ei)
    csr = conv._keep(None, torch.Generator().manual_seed(1), tei, plan, "cpu")
    coo = conv._keep(None, torch.Generator().manual_seed(1), tei, None, "cpu")
    assert csr.shape == coo.shape == (ei.shape[1], 3)
    assert torch.equal(coo[torch.from_numpy(plan.perm)], csr)
    assert 0.3 < float((csr == 0).float().mean()) < 0.7
    # a caller's mask stays in the caller's order on the COO path
    given = torch.rand(ei.shape[1], 3)
    assert torch.equal(conv._keep(given, None, tei, None, "cpu"), given)
    assert torch.equal(conv._keep(given, None, tei, plan, "cpu"),
                       given[torch.from_numpy(plan.perm)])


def test_training_paths_agree_under_one_generator():
    """Plan and COO paths draw the same input dropout and attention masks
    from one generator state, so their outputs and gradients agree."""
    x, ei = _graph(10)
    graph = Graph(x=x, edge_index=ei)
    params = _model_params(4, 2, 5, seed=11)
    y = np.random.default_rng(12).integers(0, 5, N)
    results = []
    for plan in (graph.csr_plan(), None):
        model = load_jax_params(GATV2Model(4, 5, heads=2), params).train()
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


def test_session_serves_gatv2_with_a_plan():
    x, ei = _graph(13)
    graph = Graph(x=x, edge_index=ei)
    model = load_jax_params(GATV2Model(4, 5, heads=2),
                            _model_params(4, 2, 5, seed=14))
    with compute_dtype(torch.bfloat16):
        sess = InferenceSession(model, (x, ei), device="cpu",
                                compute_dtype=torch.bfloat16,
                                plan=graph.csr_plan())
        got = sess(x, ei)
        with torch.no_grad():
            want = model(torch.tensor(x).bfloat16(), torch.tensor(ei))
    assert got.shape == (N, 5) and not model.training
    _check(got, want, 3e-2)


def test_flax_names_initialisers_and_shared_weights():
    model = GATV2Model(4, 5, heads=2)
    x, ei = _graph(15)
    model(torch.tensor(x), torch.tensor(ei))  # lazy first layer
    assert model.convs[0].lin_l.weight.shape == (8, F_IN)
    tree = model.flax_tree()
    assert list(tree) == ["GATV2Conv_0", "GATV2Conv_1"]
    assert sorted(tree["GATV2Conv_1"].flax_tree()) == [
        "Dense_0", "Dense_1", "att", "bias"]
    shared = GATV2Conv(64, 64, heads=4, share_weights=True)
    assert sorted(shared.flax_tree()) == ["Dense_0", "att", "bias"]
    assert bool((shared.bias == 0).all()) and shared.bias.shape == (256,)
    # flax's initialisers: att a unit normal cut at +-2 times 0.02; the
    # kernels glorot-uniform
    att = shared.att.detach()
    assert float(att.abs().max()) <= 0.04 and 0.01 < float(att.std()) < 0.02
    lim = float(np.sqrt(6.0 / (64 + 256)))
    w = shared.lin_l.weight.detach()
    assert float(w.abs().max()) <= lim and float(w.std()) > 0.5 * lim / 3**.5
    # a shared-weights tree carries across and leaves no second matrix
    params = {"params": _conv_params(np.random.default_rng(3), 64, 4, 64,
                                     share=True)}
    load_jax_params(shared, params)
    np.testing.assert_array_equal(shared.lin_l.weight.detach().numpy().T,
                                  params["params"]["Dense_0"]["kernel"])
