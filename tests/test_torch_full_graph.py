"""The port's full-graph GCN recipes (`gammagl_tpu_torch.parallel.
full_graph`) and its papers100M twin against the JAX package.

* Both recipes at one part against the JAX recipes on a one-device mesh,
  from the same seed: equal initial parameters, 3 losses and the eval
  logits. float32 against the JAX flat tier (XLA) at 1e-5 relative and
  the planned tier (Pallas in interpret mode, whose f32 path drops a lo*lo
  term) at 1e-4; bf16 at 3e-2 (the two packages round bf16 at other
  points).
* The same recipes at two parts under gloo against the JAX recipes on two
  virtual devices (the parameter gradients summed by ``all_reduce``).
* Staged equal to monolithic in the port; the chunked loss exact, with
  its mask gradient; `estimate_hbm_gb`, `sign_precompute` and
  `params_from_jax`; the builders asking for the card by default.
* The twin: its generator bit for bit, and a CPU run (``--device cpu
  --scale 0.00002 --epochs 3``) against the JAX recipe's losses.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu import parallel as jpar
from gammagl_tpu.parallel import full_graph as jfg
from gammagl_tpu.parallel.halo_plan import auto_src_blocks as jauto
from gammagl_tpu.utils import calc_gcn_norm_np as jnorm

from gammagl_tpu_torch import parallel as tpar
from gammagl_tpu_torch.examples import papers100m_trainer as twin
from gammagl_tpu_torch.parallel import full_graph as tfg
from gammagl_tpu_torch.utils import calc_gcn_norm_np

from tests.test_torch_halo_plan import _run_parts

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _graph(seed=0, n=200, e=1500, f=12, c=4):
    """A homophilous random graph with self-loops, GCN norms, features
    carrying the class, a training mask over 40% of the nodes."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    dst = rng.integers(0, n, e)
    order = np.argsort(y, kind="stable")
    counts = np.bincount(y, minlength=c)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    same = order[starts[y[dst]]
                 + (rng.random(e) * counts[y[dst]]).astype(np.int64)]
    src = np.where(rng.random(e) < 0.7, same, rng.integers(0, n, e))
    ei = np.concatenate([np.stack([src, dst]),
                         np.tile(np.arange(n), (2, 1))], 1)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, :c] += np.eye(c, dtype=np.float32)[y]
    mask = (rng.random(n) < 0.4).astype(np.float32)
    return ei, jnorm(ei, n), x, y, mask, c


def _partitions(tier, ei, n, w, P_=1):
    if tier == "flat":
        return (tpar.build_halo_partition(ei, n, P_, w),
                jpar.build_halo_partition(ei, n, P_, w))
    return (tpar.build_halo_partition_planned(ei, n, P_, w, R=16, ET=128,
                                              num_src_blocks=2),
            jpar.build_halo_partition_planned(ei, n, P_, w, R=16, ET=128,
                                              num_src_blocks=2))


def _jax_run(jpart, x, y, mask, c, recipe, jd, steps=3, P_=1, hidden=16,
             layers=3, lr=5e-2):
    mesh = Mesh(np.asarray(jax.devices()[:P_]), ("dp",))
    build = (jfg.make_partitioned_gcn_train_staged if recipe == "staged"
             else jfg.make_partitioned_gcn_train)
    params, opt_state, step, ev = build(
        mesh, jpart, x.shape[1], hidden, c, num_layers=layers,
        compute_dtype=jd, learning_rate=lr)
    init = {k: np.asarray(v) for k, v in params.items()}
    xs = jfg.shard_nodes(x, mesh, jpart, dtype=jd)
    ys = jfg.shard_nodes(y, mesh, jpart)
    ms = jfg.shard_nodes(mask, mesh, jpart)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    return init, losses, np.asarray(ev(params, xs), np.float32), params


def _port_run(part, x, y, mask, c, recipe, td, steps=3, hidden=16,
              layers=3, lr=5e-2, params_from=None):
    build = (tpar.make_partitioned_gcn_train_staged if recipe == "staged"
             else tpar.make_partitioned_gcn_train)
    params, opt, step, ev = build(part, x.shape[1], hidden, c,
                                  num_layers=layers, compute_dtype=td,
                                  learning_rate=lr, device="cpu")
    init = {k: v.detach().numpy().copy() for k, v in params.items()}
    if params_from is not None:
        new = tpar.params_from_jax(params_from, device="cpu")
        with torch.no_grad():
            for k_, t in params.items():
                t.copy_(new[k_])
    xs = tpar.shard_nodes(x, part, device="cpu", dtype=td)
    ys = tpar.shard_nodes(y, part, device="cpu")
    ms = tpar.shard_nodes(mask, part, device="cpu")
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, xs, ys, ms)
        losses.append(float(loss))
    return init, losses, ev(params, xs).numpy(), params


TOL = {("flat", "f32"): 1e-5, ("planned", "f32"): 1e-4,
       ("flat", "bf16"): 3e-2, ("planned", "bf16"): 3e-2}


@pytest.mark.parametrize("tier", ["planned", "flat"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("recipe", ["staged", "monolithic"])
def test_recipes_match_jax_at_one_part(tier, dtype, recipe):
    ei, w, x, y, mask, c = _graph(seed=1)
    n = x.shape[0]
    part, jpart = _partitions(tier, ei, n, w)
    jd, td = DTYPES[dtype]
    # the JAX staged recipe raises on the flat tier in bf16 (its transpose
    # vjp gets a bf16 cotangent for the tier's f32 output): that case is
    # held against the JAX monolithic recipe, the same model and step
    j_recipe = ("monolithic" if (recipe, dtype, tier) == ("staged", "bf16",
                                                          "flat")
                else recipe)
    j_init, j_losses, j_logits, _ = _jax_run(jpart, x, y, mask, c,
                                             j_recipe, jd)
    t_init, t_losses, t_logits, _ = _port_run(part, x, y, mask, c, recipe,
                                              td)
    for key, want in j_init.items():
        np.testing.assert_array_equal(t_init[key], want)
    tol = TOL[(tier, dtype)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=tol)
    assert t_losses[-1] < t_losses[0]
    assert t_logits.dtype == np.float32 and t_logits.shape == j_logits.shape
    np.testing.assert_allclose(t_logits, j_logits, rtol=tol,
                               atol=tol * np.abs(j_logits).max())


TRAIN_WORKER = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
inp, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
d = np.load(inp)
P_ = int(d["P"])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=P_,
                        timeout=datetime.timedelta(seconds=90))
from gammagl_tpu_torch import parallel as tpar
n = d["x"].shape[0]
part = tpar.build_halo_partition_planned(d["ei"], n, P_, d["w"], R=16,
                                         ET=128, num_src_blocks=2)
res = {}
for recipe in ("staged", "monolithic"):
    build = (tpar.make_partitioned_gcn_train_staged if recipe == "staged"
             else tpar.make_partitioned_gcn_train)
    params, opt, step, ev = build(part, d["x"].shape[1], 16, int(d["c"]),
                                  num_layers=3,
                                  compute_dtype=torch.float32,
                                  learning_rate=5e-2, device="cpu")
    xs, ys, ms = (tpar.shard_nodes(d[k], part, device="cpu")
                  for k in ("x", "y", "mask"))
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, xs, ys, ms)
        losses.append(float(loss))
    res[recipe + "_losses"] = np.asarray(losses)
    res[recipe + "_logits"] = ev(params, xs).numpy()
    res[recipe + "_w0"] = params["w0"].detach().numpy()
dist.destroy_process_group()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "gammagl_tpu" or m.startswith("gammagl_tpu.")]
assert not bad, bad
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


def test_recipes_across_two_processes_match_jax(tmp_path):
    ei, w, x, y, mask, c = _graph(seed=2)
    n = x.shape[0]
    parts = _run_parts(tmp_path, 2, worker=TRAIN_WORKER, ei=ei, w=w, x=x,
                       y=y, mask=mask, c=c)
    jpart = jpar.build_halo_partition_planned(ei, n, 2, w, R=16, ET=128,
                                              num_src_blocks=2)
    for recipe in ("staged", "monolithic"):
        _, j_losses, j_logits, j_params = _jax_run(
            jpart, x, y, mask, c, recipe, jnp.float32, P_=2)
        for p in parts:  # every part reports the global loss
            np.testing.assert_allclose(p[recipe + "_losses"], j_losses,
                                       rtol=1e-4)
            # the replicated parameters stay equal on every part
            np.testing.assert_array_equal(p[recipe + "_w0"],
                                          parts[0][recipe + "_w0"])
        np.testing.assert_allclose(parts[0][recipe + "_w0"],
                                   np.asarray(j_params["w0"]), rtol=1e-4,
                                   atol=1e-5)
        logits = np.concatenate([p[recipe + "_logits"] for p in parts])
        np.testing.assert_allclose(logits, j_logits, rtol=1e-4,
                                   atol=1e-4 * np.abs(j_logits).max())


def test_staged_equals_monolithic_in_the_port():
    ei, w, x, y, mask, c = _graph(seed=3)
    part, _ = _partitions("planned", ei, x.shape[0], w)
    runs = {r: _port_run(part, x, y, mask, c, r, torch.float32)
            for r in ("staged", "monolithic")}
    np.testing.assert_allclose(runs["staged"][1], runs["monolithic"][1],
                               rtol=1e-6)
    np.testing.assert_allclose(runs["staged"][2], runs["monolithic"][2],
                               rtol=1e-5, atol=1e-6)
    # remat recomputes the same layers
    build = tpar.make_partitioned_gcn_train
    grads = []
    for remat in (True, False):
        params, _, step, _ = build(part, x.shape[1], 16, c, num_layers=3,
                                   compute_dtype=torch.float32, remat=remat,
                                   device="cpu")
        xs, ys, ms = (tpar.shard_nodes(a, part, device="cpu")
                      for a in (x, y, mask))
        grads.append(step.loss_and_grads(params, xs, ys, ms)[1])
    for k_ in grads[0]:
        torch.testing.assert_close(grads[0][k_], grads[1][k_], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("n,CH", [(1000, 256), (700, 1024), (64, 64)])
def test_masked_ce_chunked_exact(n, CH):
    rng = np.random.default_rng(0)
    C = 17
    lg_np = rng.normal(size=(n, C))
    y_np = rng.integers(0, C, n)
    m_np = (rng.random(n) > 0.3).astype(np.float32)
    lg = torch.tensor(lg_np, dtype=torch.bfloat16, requires_grad=True)
    y, m = torch.from_numpy(y_np), torch.from_numpy(m_np)
    got = tfg._masked_ce_chunked(lg, y, m, CH)
    g1, = torch.autograd.grad(got, lg)
    lg2 = lg.detach().requires_grad_()
    ls = torch.nn.functional.cross_entropy(lg2.float(), y, reduction="none")
    ref = (ls * m).sum() / m.sum()
    g2, = torch.autograd.grad(ref, lg2)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_array_equal(g1.float().numpy(), g2.float().numpy())
    want = jfg._masked_ce_chunked(jnp.asarray(lg_np, jnp.bfloat16),
                                  jnp.asarray(y_np), jnp.asarray(m_np), CH)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("n,CH", [(1000, 256), (64, 64)])
@pytest.mark.parametrize("small", [False, True])
def test_masked_ce_chunked_mask_grad_matches_jax(n, CH, small):
    rng = np.random.default_rng(1)
    C = 11
    lg = rng.normal(size=(n, C)).astype(np.float32)
    y = rng.integers(0, C, n)
    m = rng.random(n).astype(np.float32) + 0.1
    if small:  # sub-unit mask sum: the max(sum m, 1) clamp holds
        m = m * 1e-3
    want = np.asarray(jax.grad(
        lambda mm: jfg._masked_ce_chunked(jnp.asarray(lg), jnp.asarray(y),
                                          mm, CH))(jnp.asarray(m)))
    mt = torch.tensor(m, requires_grad=True)
    got, = torch.autograd.grad(
        tfg._masked_ce_chunked(torch.from_numpy(lg), torch.from_numpy(y), mt,
                               CH), mt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    ref = np.asarray(jax.grad(lambda mm: (
        optax.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(lg), jnp.asarray(y)) * mm).sum()
        / jnp.maximum(mm.sum(), 1.0))(jnp.asarray(m)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("args", [
    (111_059_956, 128, 256, 3, 64, 14.55, "bf16", True),
    (1_000_000, 128, 256, 3, 1, 14.55, "bf16", True),
    (5_000, 64, 32, 2, 4, 8.0, "f32", False)])
def test_estimate_hbm_gb_matches_jax(args):
    *head, dtype, remat = args
    jd, td = DTYPES[dtype]
    assert tpar.estimate_hbm_gb(*head, td, remat) == jfg.estimate_hbm_gb(
        *head, jd, remat)


@pytest.mark.parametrize("tier", ["flat", "planned"])
def test_sign_precompute_matches_jax(tier):
    ei, w, x, _, _, _ = _graph(seed=4)
    n = x.shape[0]
    part, jpart = _partitions(tier, ei, n, w)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    want = jfg.sign_precompute(mesh, jpart, jfg.shard_nodes(x, mesh, jpart),
                               num_hops=2, store_dtype=jnp.float32)
    got = tpar.sign_precompute(part, tpar.shard_nodes(x, part, device="cpu"),
                               num_hops=2, store_dtype=torch.float32)
    tol = TOL[(tier, "f32")]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol)


def test_params_from_jax_starts_from_a_jax_trained_state():
    ei, w, x, y, mask, c = _graph(seed=5)
    part, jpart = _partitions("flat", ei, x.shape[0], w)
    _, _, j_logits, j_params = _jax_run(jpart, x, y, mask, c, "monolithic",
                                        jnp.float32, steps=2)
    tree = {k: np.asarray(v) for k, v in j_params.items()}
    params = tpar.params_from_jax(tree, device="cpu")
    assert set(params) == set(tree)
    for k_, t in params.items():
        assert t.dtype == torch.float32 and t.requires_grad and t.is_leaf
        np.testing.assert_array_equal(t.detach().numpy(), tree[k_])
    _, _, logits, _ = _port_run(part, x, y, mask, c, "monolithic",
                                torch.float32, steps=0, params_from=tree)
    np.testing.assert_allclose(logits, j_logits, rtol=1e-5,
                               atol=1e-5 * np.abs(j_logits).max())


def test_builders_ask_for_the_card_by_default(monkeypatch):
    ei, w, x, _, _, c = _graph(seed=6)
    part, _ = _partitions("planned", ei, x.shape[0], w)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tpar.make_partitioned_gcn_train,
                  tpar.make_partitioned_gcn_train_staged):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(part, x.shape[1], 8, c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.params_from_jax({"w0": np.zeros((2, 2))})
    args = twin.parser().parse_args([])
    assert args.device == "cuda" and args.hbm_gb == 8.0 and args.epochs == 12
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(twin.parser().parse_args(["--scale", "0.00002"]))


def test_params_must_be_the_optimizers():
    ei, w, x, y, mask, c = _graph(seed=7)
    part, _ = _partitions("planned", ei, x.shape[0], w)
    params, opt, step, _ = tpar.make_partitioned_gcn_train_staged(
        part, x.shape[1], 8, c, device="cpu")
    other = {k: v.detach().clone().requires_grad_()
             for k, v in params.items()}
    xs, ys, ms = (tpar.shard_nodes(a, part, device="cpu")
                  for a in (x, y, mask))
    with pytest.raises(ValueError, match="opt_state"):
        step(other, opt, xs, ys, ms)


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_papers_trainer", REPO / "examples" / "papers100m" /
        "papers100m_trainer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_twin_generator_is_the_jax_examples():
    want = _jax_example().synthetic_papers(0.00002)
    got = twin.synthetic_papers(0.00002)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    spec = importlib.util.spec_from_file_location(
        "papers_script", REPO / "scripts" / "papers100m_single_chip.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for hbm in (8.0, 2.5):
        assert twin.solve_scale(hbm, 128, 256, 3) == pytest.approx(
            script.solve_scale(hbm, 128, 256, 3), rel=1e-12)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_twin_on_the_cpu_matches_the_jax_recipe(dtype, capsys):
    argv = ["--device", "cpu", "--scale", "0.00002", "--epochs", "3"]
    if dtype == "f32":
        argv.append("--f32")
    out = twin.main(twin.parser().parse_args(argv))
    assert out["tier"] == "planned" and out["staged"]
    assert out["device"] == "cpu"
    assert '"metric": "papers100m_gcn_epoch"' in capsys.readouterr().out
    jd = DTYPES[dtype][0]
    ei, x, y, train, _, c = _jax_example().synthetic_papers(0.00002)
    n = x.shape[0]
    ei = np.concatenate([ei, np.tile(np.arange(n), (2, 1))], 1)
    w = jnorm(ei, n)
    np.testing.assert_array_equal(calc_gcn_norm_np(ei, n), w)
    nsb = jauto(n, 256, jd)
    jpart = jpar.build_halo_partition_planned(ei, n, 1, w,
                                              num_src_blocks=nsb)
    _, losses, _, _ = _jax_run(jpart, x, y, train.astype(np.float32), c,
                               "staged", jd, hidden=256, lr=1e-2)
    np.testing.assert_allclose(out["losses"], losses,
                               rtol=3e-2 if dtype == "bf16" else 1e-4)
    assert out["losses"][-1] < 0.5 * out["losses"][0]
