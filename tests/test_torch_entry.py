"""The port's entry points (`gammagl_tpu_torch/entry.py`, the counterpart of
`__graft_entry__.py`) and its examples sweep
(`gammagl_tpu_torch/examples/run_examples_smoke.py`, the counterpart of
`scripts/run_examples_smoke.py`) against the JAX repo's.

* `entry()`'s logits against the JAX `entry()`'s with its parameters
  carried across by `load_jax_params`, at 1e-5 of max |out|.
* ``python -m gammagl_tpu_torch.entry --procs 4 --device cpu`` (4 gloo
  processes): it exits 0 and prints exactly the tier names of the JAX
  function's ``_check`` calls (read from its source by AST, in order),
  each under the JAX tolerance, and both roofline lines with the figures
  JAX's `build_halo_partition` and `halo_scaling_estimate` give.
  `dryrun_multichip(2, device="cpu")` runs without the two-level tiers;
  a failed process fails the run. (That the two modules import no JAX
  is `test_torch_serve.py::test_port_imports_no_jax`.)
* The three tiers the port adds, in one process against the JAX
  function's own formulas on the same numpy inputs at 1e-5: the dp_tp
  loss and gradients (`calc_gcn_norm`, `segment_sum`, optax's
  cross-entropy), the minibatch loss and gradients on one padded batch,
  and the relation attention against `_het_dense_ref`. The two loaders
  split a global batch differently (ROADMAP C62): pinned here.
* The sweep: every JAX example dir has a twin, a dir without one fails,
  and gcn, sgc and hpn run through it on the CPU.
"""

import ast
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gammagl_tpu_torch import entry as tentry
from gammagl_tpu_torch.examples import run_examples_smoke as sweep
from gammagl_tpu_torch.parallel import DpTpGrid

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
ONE = DpTpGrid(0, 0, None, None, 1, 1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _run(argv, timeout=240):
    """A command from the repo's root: its stdout (asserting exit 0)."""
    proc = subprocess.run([sys.executable, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


# -- the JAX repo's function, read without importing it -------------------------

@functools.lru_cache(maxsize=None)
def _jax_checks():
    """[(tier name, tolerance)] of the ``_check`` calls of the JAX
    `dryrun_multichip`, in source order; an f-string name ``prefix{k}``
    runs over the parameters' names (the keys of both parameter dicts)."""
    tree = ast.parse((REPO / "__graft_entry__.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_multichip")
    dicts = {n.targets[0].id: [k.value for k in n.value.keys]
             for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and isinstance(n.value, ast.Dict) and len(n.targets) == 1
             and isinstance(n.targets[0], ast.Name)}
    keys = dicts["params"]
    assert dicts["p_mb"] == keys == ["w1", "w2"]
    calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) == "_check"),
                   key=lambda n: (n.lineno, n.col_offset))
    out = []
    for call in calls:
        tol = next((kw.value.value for kw in call.keywords
                    if kw.arg == "tol"), 2e-4)
        name = call.args[1]
        if isinstance(name, ast.Constant):
            out.append((name.value, tol))
        else:
            prefix = name.values[0].value
            out += [(prefix + k, tol) for k in keys]
    return out


@functools.lru_cache(maxsize=None)
def _jax_roofline(n):
    """The JAX function's two roofline lines at ``n`` devices, from the
    JAX package's partition and model (its code, lines 635-655)."""
    from gammagl_tpu.parallel import (build_halo_partition,
                                      halo_scaling_estimate)
    rngR = np.random.default_rng(0)
    Nb, Eb = 169_343, 2_315_598
    ei_b = np.stack([rngR.integers(0, Nb, Eb),
                     (Nb * (rngR.random(Eb) ** 1.5)).astype(np.int64)])
    lines = []
    for label, bal in (("default", True), ("balance=False", False)):
        bpart = build_halo_partition(ei_b, Nb, n, balance=bal)
        kw = dict(num_parts=bpart.num_parts,
                  edges_per_part=bpart.edge_index.shape[2],
                  halo_rows_sent=bpart.num_parts * bpart.halo_per_peer,
                  feat_dim=256, total_edges=Eb)
        est = halo_scaling_estimate(overlap=True, **kw)
        est_flat = halo_scaling_estimate(overlap=False, **kw)
        lines.append(
            f"scaling roofline (arxiv-scale, F=256 bf16, {n} "
            f"dev, {label} order): t_compute "
            f"{est['t_compute_s'] * 1e3:.2f}ms t_ici "
            f"{est['t_ici_s'] * 1e3:.2f}ms -> efficiency "
            f"{est['efficiency']:.1%} overlapped / "
            f"{est_flat['efficiency']:.1%} flat (halo rows/device "
            f"{bpart.num_parts * bpart.halo_per_peer:,})")
    return lines


def _summary(out, n, mesh):
    """(loss, {tier: err}) of the two summary lines in ``out``."""
    m = re.search(rf"^dryrun_multichip\({n}\): mesh=\({mesh[0]},{mesh[1]}\) "
                  r"loss=(\S+) parity max_rel_err=(\S+)$", out, re.M)
    assert m, out
    tiers = re.search(r"^per-tier rel err: (.*)$", out, re.M)
    assert tiers, out
    errs = dict(t.split("=") for t in tiers.group(1).split())
    errs = {k: float(v) for k, v in errs.items()}
    names = list(dict(t.split("=") for t in tiers.group(1).split()))
    assert float(m.group(2)) == pytest.approx(max(errs.values()), rel=0.06)
    return float(m.group(1)), names, errs


def _roofline_printed(out, n):
    lines = out.splitlines()
    for want in _jax_roofline(n):
        assert any(line.startswith(want + " [rates: TPU v5e")
                   for line in lines), (want, out)


# -- the JAX formulas of the three new tiers --------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_dp_tp():
    """The JAX function's one-device loss and gradients (its
    `ref_loss_fn`: `calc_gcn_norm`, `segment_sum`, optax)."""
    import jax
    import jax.numpy as jnp
    import optax
    from gammagl_tpu.ops import segment_sum
    from gammagl_tpu.utils import calc_gcn_norm
    x, ei, y, _, w1, w2 = tentry._gcn_case(False)
    n = x.shape[0]
    w = calc_gcn_norm(jnp.asarray(ei), n)

    def spmm(feat):
        msg = jnp.take(feat, jnp.asarray(ei[0]), axis=0) * w[:, None]
        return segment_sum(msg, jnp.asarray(ei[1]), n)

    def loss_fn(p):
        h1 = jax.nn.relu(spmm(jnp.asarray(x) @ p["w1"]))
        return optax.softmax_cross_entropy_with_integer_labels(
            spmm(h1 @ p["w2"]), jnp.asarray(y)).mean()

    loss, g = jax.value_and_grad(loss_fn)({"w1": jnp.asarray(w1),
                                           "w2": jnp.asarray(w2)})
    return float(loss), np.asarray(g["w1"]), np.asarray(g["w2"])


def test_dp_tp_step_matches_the_jax_loss():
    x, ei, y, w_norm, w1, w2 = tentry._gcn_case(False)
    w1_before = w1.copy()
    loss, dw1, dw2 = tentry.dp_tp_step(ONE, x, ei, w_norm, y, w1, w2, CPU)
    want, g1, g2 = _jax_dp_tp()
    _close(loss, want)
    _close(dw1, g1)
    _close(dw2, g2)
    np.testing.assert_array_equal(w1, w1_before)  # the step copies them


def _jax_mb_sums(p, b, nb):
    """The JAX function's `_mb_local` on one padded shard."""
    import jax
    import jax.numpy as jnp
    import optax
    from gammagl_tpu.ops import segment_sum
    x, y = jnp.asarray(b["x"]), jnp.asarray(b["y"])
    ei_l = jnp.asarray(b["edge_index"])
    w = jnp.asarray(b["edge_mask"]).astype(x.dtype)

    def agg(feat):
        msg = jnp.take(feat, ei_l[0], axis=0, mode="clip") * w[:, None]
        return segment_sum(msg, ei_l[1], nb)

    h1 = jax.nn.relu(agg(x @ p["w1"]))
    logits = agg(h1 @ p["w2"])
    ll = optax.softmax_cross_entropy_with_integer_labels(logits, y)
    sm = jnp.asarray(b["seed_mask"]).astype(jnp.float32)
    return jnp.sum(ll * sm), jnp.sum(sm)


def test_mb_loss_on_one_padded_batch_matches_jax():
    import jax
    import jax.numpy as jnp
    g, ei, w1, w2 = tentry._mb_case()
    batch, nb = tentry._mb_batch(g, ei, 0, 1, "cpu")
    p1 = torch.tensor(w1, requires_grad=True)
    p2 = torch.tensor(w2, requires_grad=True)
    loss = tentry.mb_loss(p1, p2, batch, nb)
    loss.backward()
    b = {k: v.numpy() for k, v in batch.items()}

    def jloss(p):
        ls, cnt = _jax_mb_sums(p, b, nb)
        return ls / cnt

    want, grads = jax.value_and_grad(jloss)({"w1": jnp.asarray(w1),
                                             "w2": jnp.asarray(w2)})
    assert int(b["seed_mask"].sum()) == 8
    _close(loss, float(want))
    _close(p1.grad, np.asarray(grads["w1"]))
    _close(p2.grad, np.asarray(grads["w2"]))


def test_loaders_split_a_global_batch_differently():
    """C62: the JAX loader splits one global batch of a process over its
    devices (shard k: seeds 8k..8k+7 of the first 32); the port's loader
    gives process k its own seed shard (`shard_seeds`: 50 of the 200), so
    its first batch takes seeds 50k..50k+7. Shard 0 is the same batch,
    bit for bit (both numpy sampler routes)."""
    import jax
    from jax.sharding import Mesh
    from gammagl_tpu.data import Graph as JGraph
    from gammagl_tpu.loader import MultiHostNodeLoader as JLoader
    from gammagl_tpu.sampler import NeighborSampler as JSampler
    from gammagl_tpu_torch.loader import MultiHostNodeLoader
    from gammagl_tpu_torch.sampler import NeighborSampler
    g, ei, _, _ = tentry._mb_case()
    jg = JGraph(edge_index=ei.astype(np.int64), x=np.asarray(g.x),
                y=np.asarray(g.y), num_nodes=g.num_nodes)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
    jl = JLoader(jg, JSampler(ei, g.num_nodes, [4, 4], seed=0,
                              use_ext=False), mesh, batch_size=8,
                 shuffle=False, process_index=0, process_count=1)
    jb = {k: np.asarray(v) for k, v in next(iter(jl)).items()}
    for k in range(4):
        tl = MultiHostNodeLoader(g, NeighborSampler(ei, g.num_nodes, [4, 4],
                                                    seed=0, use_ext=False),
                                 batch_size=8, shuffle=False,
                                 process_index=k, process_count=4,
                                 device="cpu")
        tb = {key: v[0].numpy() for key, v in next(iter(tl)).items()}
        np.testing.assert_array_equal(tb["n_id"][:8], 50 * k + np.arange(8))
        np.testing.assert_array_equal(jb["n_id"][k, :8], 8 * k + np.arange(8))
        if k == 0:
            assert tb.keys() == jb.keys()
            for key in tb:  # (JAX holds int64 ids as int32 without x64)
                np.testing.assert_array_equal(tb[key], jb[key][0])


def test_hetero_attention_matches_the_jax_dense_reference():
    import jax
    import jax.numpy as jnp
    R = 3
    rel_ei, x, wk, wq, wv = tentry._hetero_case(False, R)
    n, d = x.shape
    out, dx, dwk = tentry.hetero_step(rel_ei, x, wk, wq, wv, CPU)

    def dense(x, wk_a):  # the JAX function's `_het_dense_ref`
        total = jnp.zeros((n, d))
        for r in range(R):
            src, dst = rel_ei[r]
            k = x @ wk_a[r]
            q = x @ wq[r]
            v = x @ wv[r]
            s = jnp.sum(k[src] * q[dst], axis=-1) / np.sqrt(d)
            mx = jax.ops.segment_max(s, jnp.asarray(dst), num_segments=n)
            mx = jnp.where(jnp.isneginf(mx), 0.0, mx)
            ex = jnp.exp(s - mx[dst])
            den = jax.ops.segment_sum(ex, jnp.asarray(dst), num_segments=n)
            alpha = ex / (den[dst] + 1e-16)
            total = total + jax.ops.segment_sum(
                alpha[:, None] * v[src], jnp.asarray(dst), num_segments=n)
        return total

    want = dense(jnp.asarray(x), jnp.asarray(wk))
    gx, gk = jax.grad(lambda a, b: jnp.sum(dense(a, b) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    _close(out, np.asarray(want))
    _close(dx, np.asarray(gx))
    _close(dwk, np.asarray(gk))
    # one relation's rows without edges sum to zero
    lone = [np.stack([np.array([0, 1]), np.array([2, 2])])]
    o1, _, _ = tentry.hetero_step(lone, x, wk[:1], wq[:1], wv[:1], CPU)
    assert not o1[np.arange(n) != 2].any() and o1[2].abs().sum() > 0


# -- entry() and the dry run ---------------------------------------------------------

def test_entry_forward_matches_the_jax_entry():
    import jax
    import __graft_entry__ as jentry
    from gammagl_tpu_torch.models import GCNModel
    from gammagl_tpu_torch.utils import load_jax_params
    jfn, jargs = jentry.entry()
    want = np.asarray(jfn(*jargs))
    state = torch.random.get_rng_state()
    fn, (params, x, ei) = tentry.entry("cpu")
    assert torch.equal(torch.random.get_rng_state(), state)
    model = load_jax_params(GCNModel(hidden_dim=16, num_class=7),
                            jax.tree_util.tree_map(np.asarray, jargs[0]))
    assert set(dict(model.named_parameters())) == set(params)
    with torch.no_grad():
        got = fn(dict(model.named_parameters()), x, ei)
        own = fn(params, x, ei)
    assert got.shape == want.shape == (2708, 7)
    _close(got, want)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jargs[2]))
    assert torch.isfinite(own).all() and not torch.equal(own, got)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_in_four_processes_prints_the_jax_tiers():
    out = _run(["-m", "gammagl_tpu_torch.entry", "--procs", "4",
                "--device", "cpu"])
    assert "entry forward: (2708, 7)" in out
    loss, names, errs = _summary(out, 4, (2, 2))
    checks = _jax_checks()
    assert len(checks) == 25
    assert names == [name for name, _ in checks]
    for name, tol in checks:
        assert errs[name] < tol, (name, errs[name], tol)
    _roofline_printed(out, 4)
    assert loss == pytest.approx(_jax_dp_tp()[0], abs=5e-5)


def test_dryrun_in_two_processes_has_no_two_level_tiers(capsys):
    res = tentry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    loss, names, errs = _summary(out, 2, (1, 2))
    want = [name for name, _ in _jax_checks() if not name.startswith("hier")]
    assert names == want == list(res["errs"]) and len(want) == 22
    assert res["mesh"] == (1, 2) and len(res["ms"]) == 2
    assert errs == pytest.approx(res["errs"], rel=0.06)
    _close(res["loss"], _jax_dp_tp()[0])
    assert res["roofline"] == [ln for ln in out.splitlines()
                               if ln.startswith("scaling roofline (arxiv-"
                                                "scale, F=256 bf16, 2 dev")]
    assert len(res["roofline"]) == 4
    # the plain versions count no launches
    assert all(not counts for ms in res["launches"] for counts in ms.values())


def test_dryrun_raises_when_a_process_fails(tmp_path, monkeypatch):
    """A process that fails ends the run: the parent stops the others
    (which would wait on it in a collective) and raises with its log.
    The processes here are a stand-in interpreter: rank 1 fails at once,
    the others sleep."""
    import time
    fake = tmp_path / "python"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys, time\n"
                    "if sys.argv[-1] == '1':\n"
                    "    sys.exit('tier dp_tp_loss: max rel err 1 (tol 2e-04)')\n"
                    "time.sleep(120)\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tentry.sys, "executable", str(fake))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"process\(es\) \[1\]:\n"
                       r"-- process 1 exited 1:\ntier dp_tp_loss"):
        tentry.dryrun_multichip(3, device="cpu")
    assert time.perf_counter() - t0 < 60
    with pytest.raises(ValueError, match="processes"):
        tentry.dryrun_multichip(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(2)


# -- the examples sweep -----------------------------------------------------------

def test_every_jax_example_dir_maps_to_a_twin():
    dirs = sweep.jax_dirs()
    assert len(dirs) == len(os.listdir(REPO / "examples")) - sum(
        1 for d in os.listdir(REPO / "examples")
        if not (REPO / "examples" / d).is_dir() or d.startswith("_"))
    assert not sweep.NO_TWIN
    twins = {d: sweep.find_twin(d) for d in dirs}
    assert all(twins.values()), [d for d, t in twins.items() if not t]
    pkg = REPO / "gammagl_tpu_torch" / "examples"
    files = {f for f in os.listdir(pkg) if f.endswith(".py")} - {
        "__init__.py", "common.py", "run_examples_smoke.py"}
    assert {os.path.basename(t) for t in twins.values()} == files
    assert os.path.basename(twins["graphsage"]) == "sage_sample_trainer.py"
    assert os.path.basename(twins["database"]) == "database_trainer.py"


def test_a_dir_without_a_twin_fails(tmp_path, monkeypatch):
    for d in ("gcn", "nope", "listed"):
        (tmp_path / d).mkdir()
        (tmp_path / d / f"{d}_trainer.py").write_text("")
    monkeypatch.setattr(sweep, "EX", str(tmp_path))
    monkeypatch.setattr(sweep, "NO_TWIN", {"listed": "no reason"})
    assert sweep.jax_dirs() == ["gcn", "listed", "nope"]
    assert sweep.run_one("nope", 10, "cpu") == ("nope", "FAIL no twin", 0.0)
    assert sweep.run_one("listed", 10, "cpu")[1] == "SKIP (no reason)"
    assert sweep.find_twin("gcn").endswith("gcn_trainer.py")


def test_twin_arguments():
    m = "gammagl_tpu_torch.examples."
    assert sweep.twin_argv(m + "gcn_trainer", "cpu") == [
        "--device", "cpu", "--n_epoch", "2"]
    assert sweep.twin_argv(m + "papers100m_trainer", "cuda",
                           sweep.EXTRA_ARGS["papers100m"]) == [
        "--device", "cuda", "--scale", "0.0002", "--epochs", "2"]
    assert sweep.twin_argv(m + "neighbor_sampler", "cpu")[:1] != ["--device"]
    with pytest.raises(SystemExit):
        sweep.main(["--jobs", "2", "gcn"])  # the card takes one at a time


def test_sweep_runs_three_twins_on_the_cpu(tmp_path):
    out = _run(["-m", "gammagl_tpu_torch.examples.run_examples_smoke",
                "--device", "cpu", "--jobs", "3", "--timeout", "200",
                "--json", str(tmp_path / "s.json"), "gcn", "sgc", "hpn"],
               timeout=240)
    res = json.loads((tmp_path / "s.json").read_text())
    assert res["passed"] == res["total"] == 3, res
    assert {d: e["status"] for d, e in res["examples"].items()} == {
        "gcn": "OK", "sgc": "OK", "hpn": "OK"}
    assert "3/3 passed" in out
    assert re.search(r"^gcn {21} OK {38} +\d+\.\ds$", out, re.M), out
