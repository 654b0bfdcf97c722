"""The export trio of `serve.py` (`export_forward`, `save_exported`,
`load_exported`) and the op it records, ``gammagl::spmm_csr``.

* A COO `GCNModel` goes through export, save and load, and gives the
  JAX package's ``export_forward`` -> ``load_exported(...).call`` on the
  same parameters (rtol 1e-5, atol 1e-6).
* A planned GCN exports to a graph that calls ``gammagl.spmm_csr`` once a
  layer and holds none of the plain version's ops (no ``index_add_`` of
  feature rows, no ``repeat_interleave``; the only ``index_add_`` left
  is the degree count of GCNConv's norm, over ones); its output equals
  the eager model's bitwise, on a plan without and with cut rows.
* Tracing fills none of a plan's caches: after an export, eager calls on
  the same plan give their earlier output bitwise and a second export
  succeeds (the fault the plan caches had: ROADMAP "Found and repaired").
* `load_exported` in a fresh process gives the same logits and imports no
  `gammagl_tpu_torch.models`.
* The ops of the other kernels, and the models that reach them, are held
  in `test_torch_export_ops.py`.
* ``torch.library.opcheck`` on the op, node rows and per edge, unit,
  (E,) and (E, H) weights, and a plan with cut rows.
"""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)
import gammagl_tpu.models as jm  # noqa: E402
from gammagl_tpu import serve as jserve  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402

from gammagl_tpu_torch.models import GCNModel  # noqa: E402
from gammagl_tpu_torch.ops.cuda import ROW_SPLIT, build_csr_plan  # noqa
from gammagl_tpu_torch.serve import (export_forward,  # noqa: E402
                                     load_exported, save_exported)
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

N, FEAT, HID, CLS = 40, 12, 16, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph(seed=0, n=N, e=200, hub=0):
    """Random edges; ``hub`` more edges into node 0 (a row cut into work
    items when it passes ROW_SPLIT)."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    if hub:
        ei = np.concatenate([ei, np.stack([rng.integers(0, n, hub),
                                           np.zeros(hub, np.int64)])], 1)
    x = rng.normal(size=(n, FEAT)).astype(np.float32)
    return x, ei.astype(np.int64)


def _gcn(seed=1, layers=2):
    torch.manual_seed(seed)
    return GCNModel(hidden_dim=HID, num_class=CLS, num_layers=layers,
                    drop_rate=0.5).eval()


def _targets(ep):
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function"]


def test_coo_gcn_round_trip_matches_jax_export(tmp_path):
    x, ei = _graph()
    jmodel = jm.GCNModel(hidden_dim=HID, num_class=CLS)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(ei))
    blob = jserve.export_forward(jmodel.apply, params,
                                 (jnp.asarray(x), jnp.asarray(ei)))
    jserve.save_exported(blob, str(tmp_path / "gcn.stablehlo"))
    want = np.asarray(jserve.load_exported(
        str(tmp_path / "gcn.stablehlo")).call(jnp.asarray(x),
                                              jnp.asarray(ei)))
    model = load_jax_params(GCNModel(hidden_dim=HID, num_class=CLS),
                            _np_tree(params))
    ep = export_forward(model, (x, ei), device="cpu")
    assert "gammagl.spmm_csr.default" not in _targets(ep)  # COO: no op
    save_exported(ep, tmp_path / "gcn.pt2")
    got = load_exported(tmp_path / "gcn.pt2")(torch.from_numpy(x),
                                               torch.from_numpy(ei))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("hub", [0, ROW_SPLIT + 300])
def test_planned_gcn_records_the_op_and_not_the_plain_version(hub):
    x, ei = _graph(hub=hub)
    plan = build_csr_plan(ei[0], ei[1], N)
    assert (plan.row_split().cut_row.shape[0] > 0) == bool(hub)
    model = _gcn(layers=3)
    xt, eit = torch.from_numpy(x), torch.from_numpy(ei)
    with torch.no_grad():
        eager = model(xt, eit, plan=plan)
    ep = export_forward(model, (x, ei), device="cpu", plan=plan)
    targets = _targets(ep)
    assert targets.count("gammagl.spmm_csr.default") == 3
    assert not any("repeat_interleave" in t for t in targets)
    for node in ep.graph.nodes:  # the degree counts add ones, (N + 1,)
        if node.op == "call_function" and "index_add" in str(node.target):
            assert node.args[3].meta["val"].dim() == 1
    buffers = dict(ep.named_buffers())
    assert any(k.endswith("plan_col") for k in buffers)
    assert any(k.endswith("plan_item_meta") for k in buffers) == bool(hub)
    np.testing.assert_array_equal(ep.module()(xt, eit).detach().numpy(),
                                  eager.numpy())


def test_export_leaves_the_plan_unpoisoned():
    """After an export the same plan's eager calls are bitwise what they
    were, its caches hold real tensors only, and a second export works."""
    x, ei = _graph(hub=ROW_SPLIT + 50)
    plan = build_csr_plan(ei[0], ei[1], N)
    model = _gcn()
    xt, eit = torch.from_numpy(x), torch.from_numpy(ei)
    with torch.no_grad():
        first = model(xt, eit, plan=plan)   # fills the caches, eagerly
    for _ in range(2):
        export_forward(model, (x, ei), device="cpu", plan=plan)
        with torch.no_grad():
            again = model(xt, eit, plan=plan)
        np.testing.assert_array_equal(again.numpy(), first.numpy())
    fresh = build_csr_plan(ei[0], ei[1], N)  # exported before any eager call
    ep = export_forward(model, (x, ei), device="cpu", plan=fresh)
    cached = [t for v in fresh._placed.values() for t in v] + [
        t for v in fresh._split_placed.values() for t in v
        if isinstance(t, torch.Tensor)]
    assert cached and all(type(t) is torch.Tensor for t in cached)
    with torch.no_grad():
        np.testing.assert_array_equal(model(xt, eit, plan=fresh).numpy(),
                                      first.numpy())
    np.testing.assert_array_equal(ep.module()(xt, eit).detach().numpy(),
                                  first.numpy())
    # the probe that found the fault: the plan held by a module and traced
    # by torch.export itself, before any eager call, then used eagerly
    # (the cache then held fake tensors: wrong logits without an error, and
    # a second export refused them)
    probe = build_csr_plan(ei[0], ei[1], N)

    class Held(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, v, e):
            return self.model(v, e, plan=probe)

    for _ in range(2):
        torch.export.export(Held(), (xt, eit))
        with torch.no_grad():
            np.testing.assert_array_equal(
                model(xt, eit, plan=probe).numpy(), first.numpy())


def test_tracing_fills_no_cache_of_a_plan():
    x, ei = _graph(hub=ROW_SPLIT + 10)
    plan = build_csr_plan(ei[0], ei[1], N)

    class Reads(torch.nn.Module):
        def forward(self, v):
            tp = plan.transpose()
            es = plan.edge_scatter_plan()
            rowptr, col, _ = plan.arrays(v.device)
            item_ptr = plan.split_arrays(v.device)[0]
            return (v[col.long()].sum() + rowptr.sum() + item_ptr.sum()
                    + tp.arrays(v.device)[1].sum()
                    + es.arrays(v.device)[1].sum())

    torch.export.export(Reads(), (torch.from_numpy(x),))
    assert plan._placed == {} and plan._split_placed == {}
    assert plan._transpose is None and plan._edge_scatter is None


def test_load_exported_in_a_fresh_process_imports_no_model_code(tmp_path):
    x, ei = _graph()
    plan = build_csr_plan(ei[0], ei[1], N)
    model = _gcn(layers=3)
    save_exported(export_forward(model, (x, ei), device="cpu", plan=plan),
                  tmp_path / "gcn.pt2")
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "ei.npy", ei)
    code = (
        "import sys, numpy as np, torch\n"
        "from gammagl_tpu_torch.serve import load_exported\n"
        f"d = {str(tmp_path)!r}\n"
        "prog = load_exported(d + '/gcn.pt2')\n"
        "out = prog(torch.from_numpy(np.load(d + '/x.npy')),\n"
        "           torch.from_numpy(np.load(d + '/ei.npy')))\n"
        "np.save(d + '/out.npy', out.detach().numpy())\n"
        "bad = [m for m in sys.modules if m.startswith("
        "('gammagl_tpu_torch.models', 'gammagl_tpu_torch.layers', 'jax', "
        "'gammagl_tpu.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.from_numpy(ei), plan=plan)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  want.numpy())


@pytest.mark.parametrize("per_edge", [0, 1])
@pytest.mark.parametrize("weights", ["none", "edge", "heads"])
@pytest.mark.parametrize("hub", [0, ROW_SPLIT + 7])
def test_op_passes_opcheck(per_edge, weights, hub):
    from gammagl_tpu_torch.ops.cuda.segment_matmul import _op_args
    x, ei = _graph(seed=3, hub=hub)
    plan = build_csr_plan(ei[0], ei[1], N)
    g = torch.Generator().manual_seed(4)
    rows = plan.num_edges if per_edge else N
    v = torch.randn(rows, 8, generator=g)
    w = {"none": None, "edge": torch.rand(plan.num_edges, generator=g),
         "heads": torch.rand(plan.num_edges, 2, generator=g)}[weights]
    args = (v, w, *_op_args(plan, v.device), per_edge)
    torch.library.opcheck(torch.ops.gammagl.spmm_csr.default, args)
