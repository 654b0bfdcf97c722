"""The slice as a whole: the port's InferenceSession on the CPU against
the JAX InferenceSession (gammagl_tpu/serve.py), same parameters, same
graph, bf16 compute, with the CSR plan.

Tolerance 3e-2 of max |logit|: the JAX package's own plan and XLA paths
already differ by about 0.9% of max |logit| on this graph in bf16.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.models import GCNModel as JaxGCNModel
from gammagl_tpu.serve import InferenceSession as JaxInferenceSession

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.serve import InferenceSession
from gammagl_tpu_torch.utils import load_jax_params

REPO = Path(__file__).resolve().parents[1]
N, E, F_IN, HIDDEN, N_CLASS = 1000, 8000, 32, 64, 10


def _setup():
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    x = rng.normal(size=(N, F_IN)).astype(np.float32)
    jmodel = JaxGCNModel(hidden_dim=HIDDEN, num_class=N_CLASS, num_layers=3,
                         dtype=jnp.bfloat16)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(ei))
    params = jax.tree_util.tree_map(np.asarray, params)
    return x, ei, jmodel, params


def _port_model(params):
    model = GCNModel(hidden_dim=HIDDEN, num_class=N_CLASS, num_layers=3,
                     dtype=torch.bfloat16)
    return load_jax_params(model, params)


def test_session_matches_jax_session_bf16_with_plan():
    x, ei, jmodel, params = _setup()
    jgraph = JaxGraph(x=x, edge_index=ei).add_self_loop()
    jei = jnp.asarray(jgraph.edge_index)
    jsess = JaxInferenceSession(jmodel.apply, params, (jnp.asarray(x), jei),
                                compute_dtype=jnp.bfloat16,
                                plan=jgraph.csr_plan())
    want = np.asarray(jsess(jnp.asarray(x), jei), np.float32)

    graph = Graph(x=x, edge_index=ei).add_self_loop()
    sess = InferenceSession(_port_model(params), (x, graph.edge_index),
                            device="cpu",
                            compute_dtype=torch.bfloat16,
                            plan=graph.csr_plan())
    got = sess(x, graph.edge_index)
    assert got.dtype == torch.float32 and got.shape == (N, N_CLASS)
    assert got.is_inference() and not sess.model.training
    got = got.numpy()
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * scale)
    # tensors in, tensors out: the same answer
    again = sess(torch.from_numpy(x), torch.from_numpy(graph.edge_index))
    np.testing.assert_array_equal(again.numpy(), got)


def test_session_casts_inputs_for_an_f32_model():
    """compute_dtype only casts the inputs; a model without a dtype then
    computes in f32, as flax promotes bf16 inputs against f32 kernels."""
    x, ei, _, _ = _setup()
    jmodel = JaxGCNModel(hidden_dim=HIDDEN, num_class=N_CLASS)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x),
                         jnp.asarray(ei))
    params = jax.tree_util.tree_map(np.asarray, params)
    want = JaxInferenceSession(jmodel.apply, params, (x, ei),
                               compute_dtype=jnp.bfloat16)(x, ei)
    model = load_jax_params(GCNModel(hidden_dim=HIDDEN, num_class=N_CLASS),
                            params)
    got = InferenceSession(model, (x, ei), device="cpu",
                           compute_dtype=torch.bfloat16)(x, ei)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_load_jax_params_raises_on_missing_key():
    _, _, _, params = _setup()
    del params["params"]["GCNConv_1"]["bias"]
    with pytest.raises(KeyError, match="GCNConv_1/bias"):
        _port_model(params)


def test_load_jax_params_raises_on_extra_key():
    _, _, _, params = _setup()
    params["params"]["GCNConv_3"] = params["params"]["GCNConv_2"]
    with pytest.raises(KeyError, match="extra"):
        _port_model(params)


def test_load_jax_params_raises_on_wrong_shape():
    _, _, _, params = _setup()
    k = params["params"]["GCNConv_1"]["Dense_0"]["kernel"]
    params["params"]["GCNConv_1"]["Dense_0"]["kernel"] = k[:, :-1]
    with pytest.raises(ValueError, match="GCNConv_1/Dense_0/kernel"):
        _port_model(params)
    with pytest.raises(KeyError, match="params"):
        load_jax_params(GCNModel(), {"GCNConv_0": {}})


def test_load_jax_params_transposes_kernels():
    _, _, _, params = _setup()
    model = _port_model(params)
    for i, conv in enumerate(model.convs):
        tree = params["params"][f"GCNConv_{i}"]
        np.testing.assert_array_equal(conv.linear.weight.detach().numpy(),
                                      tree["Dense_0"]["kernel"].T)
        np.testing.assert_array_equal(conv.bias.detach().numpy(),
                                      tree["bias"])
    assert model.convs[0].linear.in_features == F_IN


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, gammagl_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "p.__path__, 'gammagl_tpu_torch.')]; "
            "assert 'gammagl_tpu_torch.examples.gatv2_trainer' in sys.modules; "
            "assert 'gammagl_tpu_torch.examples.hgt_trainer' in sys.modules; "
            "assert 'gammagl_tpu_torch.ops.cuda.hetero_flash' in sys.modules; "
            "assert 'gammagl_tpu_torch.ops.cuda.segment_max' in sys.modules; "
            "assert 'gammagl_tpu_torch.ops.cuda.block_pair' in sys.modules; "
            "assert 'gammagl_tpu_torch.parallel.partition' in sys.modules; "
            "assert 'gammagl_tpu_torch.parallel.halo_plan' in sys.modules; "
            "assert 'gammagl_tpu_torch.parallel.full_graph' in sys.modules; "
            "assert 'gammagl_tpu_torch.parallel.mesh' in sys.modules; "
            "assert 'gammagl_tpu_torch.utils.norm' in sys.modules; "
            "assert 'gammagl_tpu_torch.ops.sparse' in sys.modules; "
            "assert 'gammagl_tpu_torch.sparse.sparse_graph' in sys.modules; "
            "assert 'gammagl_tpu_torch.layers.conv.rgcn_conv' in "
            "sys.modules; "
            "assert all('gammagl_tpu_torch.examples.' + t + '_trainer' in "
            "sys.modules for t in ('rgcn', 'han', 'simplehgn', 'gat')); "
            "assert 'gammagl_tpu_torch.examples.papers100m_trainer' in "
            "sys.modules; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'gammagl_tpu.')) or "
            "m == 'gammagl_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    cwd = REPO
    if where == "alone":  # a directory holding chip_smoke.py and nothing else
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession(GCNModel(), (np.zeros((2, 3), np.float32),
                                      np.zeros((2, 0), np.int64)),
                         device="cuda")


def test_session_without_a_device_asks_for_the_card():
    """``device=None`` means the CUDA card: without one the session
    raises instead of running on the CPU (ROADMAP C3)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceSession(GCNModel(), (np.zeros((2, 3), np.float32),
                                      np.zeros((2, 0), np.int64)))
