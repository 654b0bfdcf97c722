"""The port's GCNConv and GCNModel against the JAX package.

One numpy parameter tree feeds both packages (the port through
`load_jax_params`). Degrees stay under 256: the JAX bf16 path counts
degrees in bf16, which saturates there (ROADMAP queue C); the last test
documents that difference.

Tolerances, relative to max |out|: f32 1e-5 on the XLA path and 1e-4 on
the Pallas path (bf16x3); bf16 3e-2, because the JAX bf16 path rounds its
edge weights and tile sums to bf16 and the port keeps both in f32.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.layers.conv import GCNConv as JaxGCNConv
from gammagl_tpu.models import GCNModel as JaxGCNModel

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.layers.conv import GCNConv, MessagePassing
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.utils import compute_dtype, load_jax_params

N, N_LINKED, E, F_IN = 120, 100, 700, 12


def _graph(seed=0):
    """Edges among the first N_LINKED nodes; the rest are isolated, so
    every norm mode meets zero degrees."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, N_LINKED, (2, E))
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    return x, ei


def _dense(rng, fan_in, fan_out):
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    return {"Dense_0": {"kernel": rng.uniform(-lim, lim, (fan_in, fan_out))
                        .astype(np.float32)},
            "bias": rng.uniform(-0.5, 0.5, fan_out).astype(np.float32)}


def _model_params(dims, seed=1):
    rng = np.random.default_rng(seed)
    return {"params": {f"GCNConv_{i}": _dense(rng, dims[i], dims[i + 1])
                       for i in range(len(dims) - 1)}}


def _check(got, want, rtol):
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _tol(dtype, plan):
    if dtype == "bf16":
        return 3e-2
    return 1e-4 if plan else 1e-5


DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("norm", ["both", "left", "right", "none"])
@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gcn_conv_matches_jax(norm, plan, dtype):
    x, ei = _graph()
    jdt, tdt = DTYPES[dtype]
    params = {"params": _dense(np.random.default_rng(2), F_IN, 16)}
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan() if plan else None
    want = JaxGCNConv(16, norm=norm, dtype=jdt).apply(
        params, jnp.asarray(x), jnp.asarray(ei), plan=jplan)
    conv = load_jax_params(GCNConv(F_IN, 16, norm=norm, dtype=tdt), params)
    tplan = Graph(x=x, edge_index=ei).csr_plan() if plan else None
    got = conv(torch.from_numpy(x), torch.from_numpy(ei), plan=tplan)
    assert got.dtype == torch.float32  # bias is f32, as in flax
    _check(got, want, _tol(dtype, plan))
    assert bool((got[N_LINKED:] == conv.bias).all())  # isolated: bias only


@pytest.mark.parametrize("layers,hidden", [(2, 32), (3, 64)])
@pytest.mark.parametrize("plan", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gcn_model_matches_jax(layers, hidden, plan, dtype):
    x, ei = _graph(3)
    ei = np.asarray(Graph(x=x, edge_index=ei).add_self_loop().edge_index)
    jdt, tdt = DTYPES[dtype]
    params = _model_params([F_IN] + [hidden] * (layers - 1) + [5])
    jplan = JaxGraph(x=x, edge_index=ei).csr_plan() if plan else None
    want = JaxGCNModel(hidden_dim=hidden, num_class=5, num_layers=layers,
                       dtype=jdt).apply(params, jnp.asarray(x),
                                        jnp.asarray(ei), plan=jplan)
    model = GCNModel(hidden_dim=hidden, num_class=5, num_layers=layers,
                     dtype=tdt)
    load_jax_params(model, params).eval()
    tplan = Graph(x=x, edge_index=ei).csr_plan() if plan else None
    got = model(torch.from_numpy(x), torch.from_numpy(ei), plan=tplan)
    _check(got, want, _tol(dtype, plan))


def test_lazy_first_layer_takes_glorot_init():
    x, ei = _graph()
    model = GCNModel(hidden_dim=8, num_class=3).eval()
    out = model(torch.from_numpy(x), torch.from_numpy(ei))
    weight = model.convs[0].linear.weight.detach()
    assert out.shape == (N, 3) and weight.shape == (8, F_IN)
    assert float(weight.abs().max()) <= np.sqrt(6.0 / (F_IN + 8))


def test_dropout_is_active_in_training_only():
    x, ei = _graph()
    model = GCNModel(hidden_dim=64, num_class=3, drop_rate=0.5)
    args = (torch.from_numpy(x), torch.from_numpy(ei))
    torch.manual_seed(0)
    train = model.train()(*args)
    evals = [model.eval()(*args) for _ in range(2)]
    assert torch.equal(evals[0], evals[1])
    assert not torch.allclose(train, evals[0])


def test_global_compute_dtype_is_the_default():
    x, ei = _graph()
    params = {"params": _dense(np.random.default_rng(4), F_IN, 8)}
    explicit = load_jax_params(GCNConv(F_IN, 8, dtype=torch.bfloat16), params)
    implicit = load_jax_params(GCNConv(F_IN, 8), params)
    args = (torch.from_numpy(x), torch.from_numpy(ei))
    with compute_dtype(torch.bfloat16):
        got = implicit(*args)
    assert torch.equal(got, explicit(*args))
    assert not torch.equal(implicit(*args), got)


def test_invalid_norm_raises():
    with pytest.raises(ValueError, match="invalid norm"):
        GCNConv(4, 4, norm="sym")


class _Aggr(MessagePassing):
    def __init__(self, aggr):
        super().__init__()
        self.aggr = aggr

    def forward(self, x, edge_index, edge_weight=None, plan=None):
        return self.propagate(x, edge_index, aggr=self.aggr,
                              edge_weight=edge_weight, plan=plan)


@pytest.mark.parametrize("weighted", [False, True])
def test_mean_with_plan_matches_plain_mean(weighted):
    x, ei = _graph(5)
    w = (torch.from_numpy(np.random.default_rng(6).random(E)
                          .astype(np.float32)) if weighted else None)
    args = (torch.from_numpy(x), torch.from_numpy(ei), w)
    plan = Graph(x=x, edge_index=ei).csr_plan()
    got = _Aggr("mean")(*args, plan=plan)
    want = _Aggr("mean")(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_max_with_plan_names_the_missing_kernel():
    """The segment-max kernel is ported: with a plan, 'max' runs
    `spmm_max_csr` (its plain version here) and equals the plain path bit
    for bit, where it used to raise naming the missing kernel."""
    x, ei = _graph()
    plan = Graph(x=x, edge_index=ei).csr_plan()
    got = _Aggr("max")(torch.from_numpy(x), torch.from_numpy(ei), plan=plan)
    plain = _Aggr("max")(torch.from_numpy(x), torch.from_numpy(ei))
    assert plain.shape == (N, F_IN) and torch.equal(got, plain)


def test_bf16_degrees_do_not_saturate_unlike_the_reference():
    """A hub with 300 in-edges: the JAX bf16 GCNConv counts its degree in
    bf16 and gets 256, so its hub row is off by about sqrt(301/256) - 1 =
    8%; the port counts in f32 and stays within bf16 rounding."""
    hub = np.stack([np.arange(1, 301), np.zeros(300, np.int64)])
    ei = np.asarray(Graph(edge_index=hub, num_nodes=301)
                    .add_self_loop().edge_index)
    x = np.random.default_rng(7).normal(size=(301, 4)).astype(np.float32)
    params = {"params": _dense(np.random.default_rng(8), 4, 4)}
    params["params"]["bias"][:] = 0.0
    args = (jnp.asarray(x), jnp.asarray(ei))
    exact = np.asarray(JaxGCNConv(4).apply(params, *args))[0]
    jax_bf16 = np.asarray(JaxGCNConv(4, dtype=jnp.bfloat16).apply(
        params, *args), np.float32)[0]
    conv = load_jax_params(GCNConv(4, 4, dtype=torch.bfloat16), params)
    port_bf16 = conv(torch.from_numpy(x), torch.from_numpy(ei))[0]
    scale = np.abs(exact).max()
    assert np.abs(jax_bf16 - exact).max() > 0.05 * scale
    np.testing.assert_allclose(port_bf16.float().detach().numpy(), exact,
                               rtol=0, atol=2e-2 * scale)
