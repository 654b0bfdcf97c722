"""The port's edge partitions, edge-sharded SpMM and the feature-sharded,
relation-expert and pipeline strategies (`gammagl_tpu_torch.parallel`
`partition.py`, `spmm.py`, `strategies.py`) against the JAX package.

* `EdgePartition`'s fields bit for bit, both strategies, with and without
  weights, at 1, 3 and 8 parts (the shard length's round-up to 128, the
  pads ``dst = src = N`` of weight 0).
* In this process (one part, no group): the sharded SpMM of both
  partitions, the feature-sharded SpMM, the expert SpMM (R = 7 relations)
  and the pipeline (one stage): outputs and the gradients of a weighted
  sum against the JAX functions on a one-device mesh and ``jax.grad``,
  f32 at 1e-5 (the expert SpMM 1e-4 / 1e-5 as JAX's own test); the
  shard's plan built once over repeated calls.
* Two and four gloo processes (the CPU, one module-scoped job a size;
  the workers import no JAX): the same against JAX on as many virtual
  devices. By destination, the output is bitwise one plan's `spmm_csr`;
  each process's weight gradient is its own shard's, zeros elsewhere;
  the expert blocks at 4 processes hold a padding relation (R = 7, per =
  2), whose gradient is zero; the pipeline at S = 4, M = 5 against JAX's
  and the sequential composition, parameters and microbatches.

The JAX references are computed once a module, one ``jax.jit`` of outputs
and gradients each. The workers import this module for its port-side
helpers, so JAX is imported inside the reference functions only.
"""

import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gammagl_tpu_torch import parallel as tpar
from gammagl_tpu_torch.ops import cuda as k
from gammagl_tpu_torch.parallel import spmm as tspmm
from gammagl_tpu_torch.parallel import strategies as tstrat

N, E, F = 64, 400, 16               # the sharded SpMMs (F: 4 column blocks)
XN, XE, XF, XO, XR = 24, 90, 8, 6, 7  # the expert SpMM (JAX's test)
S_M, S_B, S_F = 5, 8, 12            # the pipeline: microbatches, rows, width
TOL = 1e-5
REPO = Path(__file__).resolve().parents[1]


def _graph():
    rng = np.random.default_rng(11)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    w = rng.normal(size=E).astype(np.float32)
    x = rng.normal(size=(N, F)).astype(np.float32)
    coef = rng.normal(size=(N, F)).astype(np.float32)
    return ei, w, x, coef


def _expert_case():
    rng = np.random.default_rng(4)
    ei = np.stack([rng.integers(0, XN, XE), rng.integers(0, XN, XE)])
    et = rng.integers(0, XR, XE)
    x = rng.normal(size=(XN, XF)).astype(np.float32)
    W = rng.normal(size=(XR, XF, XO)).astype(np.float32) * 0.1
    coef = rng.normal(size=(XN, XO)).astype(np.float32)
    return ei, et, x, W, coef


def _pipe_case(S):
    rng = np.random.default_rng(5)
    params = rng.normal(size=(S, S_F, S_F)).astype(np.float32) * 0.1
    xm = rng.normal(size=(S_M, S_B, S_F)).astype(np.float32)
    coef = rng.normal(size=(S_M, S_B, S_F)).astype(np.float32)
    return params, xm, coef


def _mesh(P_, axis):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:P_]), (axis,))


def _jax():
    """The JAX modules of the references (imported here: the workers
    import this module and must not import JAX)."""
    import jax
    import jax.numpy as jnp
    from gammagl_tpu import parallel as jpar
    return jax, jnp, jpar


def _check(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


# -- the partitions ----------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("kind", ["dst", "uniform"])
def test_edge_partition_fields_are_jax_bit_for_bit(kind, parts, weighted):
    jax, jnp, jpar = _jax()
    ei, w, _, _ = _graph()
    w = w if weighted else None
    name = f"partition_edges_{'by_dst' if kind == 'dst' else 'uniform'}"
    got = getattr(tpar, name)(ei, N, parts, w)
    want = getattr(jpar, name)(ei, N, parts, w)
    assert isinstance(got, tpar.EdgePartition)
    for field in ("edge_index", "edge_weight", "row_start"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b)
    assert (got.num_parts, got.num_nodes) == (want.num_parts, want.num_nodes)
    assert got.edge_index.shape[2] % 128 == 0


# -- the JAX references ------------------------------------------------------

def _partition(kind, P_):
    """The port's partition (its fields are JAX's, bit for bit)."""
    ei, w, _, _ = _graph()
    build = (tpar.partition_edges_by_dst if kind == "dst"
             else tpar.partition_edges_uniform)
    return build(ei, N, P_, w)


@functools.lru_cache(maxsize=None)
def _jax_sharded(kind, P_):
    """JAX's sharded SpMM on P_ devices: out, dx, dw of sum(out * coef)."""
    jax, jnp, jpar = _jax()
    _, _, x, coef = _graph()
    part = _partition(kind, P_)
    fn = jpar.make_sharded_spmm(_mesh(P_, "dp"), N)
    eis = jnp.asarray(part.edge_index)

    def loss(x, ws):
        out = fn(eis, ws, x)
        return jnp.sum(out * coef), out

    (_, out), (dx, dw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                             jnp.asarray(part.edge_weight))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


@functools.lru_cache(maxsize=None)
def _jax_feature(P_):
    """JAX's feature-sharded SpMM over P_ column blocks: out and dx."""
    jax, jnp, jpar = _jax()
    ei, w, x, coef = _graph()
    fn = jpar.make_feature_sharded_spmm(_mesh(P_, "sp"), N)

    def loss(x):
        out = fn(jnp.asarray(ei), jnp.asarray(w), x)
        return jnp.sum(out * coef), out

    (_, out), dx = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    from gammagl_tpu.ops import spmm as jax_spmm
    ref = jax_spmm(jnp.asarray(ei), jnp.asarray(w), jnp.asarray(x),
                   num_nodes=N)
    return np.asarray(out), np.asarray(dx), np.asarray(ref)


@functools.lru_cache(maxsize=None)
def _jax_expert(P_):
    """JAX's expert SpMM on P_ devices: out, dx and the (P_, per, F_in,
    F_out) dW; and the per-edge reference's out, dx and dW."""
    jax, jnp, jpar = _jax()
    ei, et, x, W, coef = _expert_case()
    mesh = _mesh(P_, "ep")
    run = jpar.make_relation_expert_spmm(mesh, XN)
    ws = jpar.shard_expert_weights(mesh, jnp.asarray(W))

    def loss(x, w):
        out = run(jnp.asarray(ei), jnp.asarray(et), x, w)
        return jnp.sum(out * coef), out

    (_, out), (dx, dw) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), ws)

    def ref_loss(x, W):
        msg = jnp.einsum("ef,efo->eo", x[ei[0]], W[et])
        out = jax.ops.segment_sum(msg, ei[1], num_segments=XN)
        return jnp.sum(out * coef), out

    (_, rout), (rdx, rdw) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                                 jnp.asarray(W))
    return tuple(np.asarray(a) for a in (out, dx, dw, rout, rdx, rdw))


def _stage(p, h):
    import jax.numpy as jnp
    return jnp.tanh(h @ p)


@functools.lru_cache(maxsize=None)
def _jax_pipeline(S):
    """JAX's GPipe at S stages and M = S_M: out, d params, d xm; and the
    sequential composition's."""
    jax, jnp, jpar = _jax()
    params, xm, coef = _pipe_case(S)
    mesh = _mesh(S, "pp")
    run = jpar.make_pipeline_apply(mesh, _stage, S_M)
    ps = jpar.shard_pipeline_params(mesh, jnp.asarray(params))

    def loss(p, xm):
        out = run(p, xm)
        return jnp.sum(out * coef), out

    (_, out), (dp, dxm) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(ps, jnp.asarray(xm))

    def seq(p, xm):
        h = xm
        for s in range(S):
            h = jnp.tanh(h @ p[s])
        return jnp.sum(h * coef), h

    (_, sout), (sdp, sdxm) = jax.jit(jax.value_and_grad(
        seq, argnums=(0, 1), has_aux=True))(jnp.asarray(params),
                                            jnp.asarray(xm))
    return tuple(np.asarray(a) for a in (out, dp, dxm, sout, sdp, sdxm))


# -- the port in one process, and in its workers ------------------------------

def _port_sharded(kind, P_, rank=0, counter=None):
    """The port's sharded SpMM as process ``rank`` of P_ runs it (one
    process: no group)."""
    _, _, x, coef = _graph()
    part = _partition(kind, P_)
    spmm = tpar.make_sharded_spmm(N)
    xt = torch.tensor(x, requires_grad=True)
    ws = torch.tensor(part.edge_weight, requires_grad=True)
    eis = np.asarray(part.edge_index)
    for _ in range(3):  # one plan for the same edge array
        out = spmm(eis, ws, xt)
    (out * torch.from_numpy(coef)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), ws.grad.numpy()


@pytest.fixture
def builds(monkeypatch):
    """The plans the sharded, feature-sharded and expert SpMMs build."""
    built = []
    for mod in (tspmm, tstrat):
        monkeypatch.setattr(mod, "build_csr_plan", lambda *a, _real=(
            mod.build_csr_plan), **kw: built.append(1) or _real(*a, **kw))
    return built


def test_sharded_spmm_at_one_part_matches_jax(builds):
    for kind in ("dst", "uniform"):
        out, dx, dw = _port_sharded(kind, 1)
        want, want_dx, want_dw = _jax_sharded(kind, 1)
        _check(out, want)
        _check(dx, want_dx)
        _check(dw, want_dw)
    assert len(builds) == 2  # one plan a partition, over 3 calls each


def test_sharded_spmm_one_call_and_bf16():
    jax, jnp, jpar = _jax()
    _, _, x, _ = _graph()
    part = _partition("uniform", 1)
    one = tpar.sharded_spmm(part.edge_index, part.edge_weight,
                            torch.from_numpy(x), N)
    want, _, _ = _jax_sharded("uniform", 1)
    _check(one.numpy(), want)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tpar.sharded_spmm(part.edge_index, torch.from_numpy(
        part.edge_weight), xb, N)
    assert got.dtype == torch.float32  # x * w with w float32, as JAX
    with pytest.raises(ValueError, match="stack"):
        tpar.sharded_spmm(part.edge_index[0], part.edge_weight, xb, N)
    jx = jnp.asarray(x, jnp.bfloat16)
    jwant = jpar.sharded_spmm(_mesh(1, "dp"), jnp.asarray(part.edge_index),
                              jnp.asarray(part.edge_weight), jx, N)
    assert jwant.dtype == jnp.float32
    _check(got.numpy(), np.asarray(jwant))


def _port_feature(P_, rank=0):
    ei, w, x, coef = _graph()
    c = F // P_
    run = tpar.make_feature_sharded_spmm(N)
    xb = torch.tensor(x[:, rank * c:(rank + 1) * c], requires_grad=True)
    for _ in range(2):
        out = run(ei, torch.from_numpy(w), xb)
    (out * torch.from_numpy(coef[:, rank * c:(rank + 1) * c])).sum() \
        .backward()
    return out.detach().numpy(), xb.grad.numpy()


def test_feature_sharded_spmm_at_one_part_matches_jax(builds):
    jax, jnp, jpar = _jax()
    out, dx = _port_feature(1)
    assert len(builds) == 1
    want, want_dx, ref = _jax_feature(1)
    _check(out, want)
    _check(out, ref)
    _check(dx, want_dx)
    ei, _, x, _ = _graph()
    unit = tpar.make_feature_sharded_spmm(N)(ei, None, torch.from_numpy(x))
    _check(unit.numpy(), np.asarray(jpar.make_feature_sharded_spmm(
        _mesh(1, "sp"), N)(jnp.asarray(ei), None, jnp.asarray(x))))


def _port_expert(P_, rank=0):
    ei, et, x, W, coef = _expert_case()
    run = tpar.make_relation_expert_spmm(XN)
    wl = tpar.shard_expert_weights(W, device="cpu").requires_grad_()
    xt = torch.tensor(x, requires_grad=True)
    eit, ett = torch.from_numpy(ei), torch.from_numpy(et)
    for _ in range(2):
        out = run(eit, ett, xt, wl)
    (out * torch.from_numpy(coef)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), wl.grad.numpy()


def _check_expert(got, P_):
    """got: each process's (out, dx, dW block)."""
    out, dx, dw, rout, rdx, rdw = _jax_expert(P_)
    per = -(-XR // P_)
    for r, (o, gx, gw) in enumerate(got):
        _check(o, out)
        _check(o, rout, 1e-4)
        _check(gx, dx)
        _check(gx, rdx, 1e-4)
        _check(gw, dw[r])
    flat = np.concatenate([g[2] for g in got])
    assert flat.shape == (per * P_, XF, XO)
    np.testing.assert_allclose(flat[:XR], rdw, rtol=1e-4, atol=1e-5)
    assert not flat[XR:].any()  # the padding relations' gradient


def test_expert_spmm_at_one_part_matches_jax(builds):
    _check_expert([_port_expert(1)], 1)
    assert len(builds) == 1  # one plan over 2 calls
    ei, et, x, W, _ = _expert_case()
    one = tpar.relation_expert_spmm(ei, et, x, W, XN, device="cpu")
    _check(one.numpy(), _jax_expert(1)[0])


def _port_pipeline(S, rank=0):
    params, xm, coef = _pipe_case(S)
    p = tpar.shard_pipeline_params(params, device="cpu").requires_grad_()
    xt = torch.tensor(xm, requires_grad=True)
    run = tpar.make_pipeline_apply(lambda p, h: torch.tanh(h @ p), S_M)
    out = run(p, xt)
    (out * torch.from_numpy(coef)).sum().backward()
    return out.detach().numpy(), p.grad.numpy(), xt.grad.numpy()


def _check_pipeline(got, S):
    out, dp, dxm, sout, sdp, sdxm = _jax_pipeline(S)
    for r, (o, gp, gx) in enumerate(got):
        _check(o, out)
        _check(o, sout)
        _check(gx, dxm)
        _check(gx, sdxm)
        _check(gp, dp[r], 1e-4)
        _check(gp, sdp[r], 1e-4)


def test_pipeline_at_one_stage_matches_jax():
    _check_pipeline([_port_pipeline(1)], 1)
    params, xm, _ = _pipe_case(1)
    one = tpar.pipeline_apply(lambda p, h: torch.tanh(h @ p), params, xm,
                              device="cpu")
    _check(one.numpy(), _jax_pipeline(1)[0])


# -- two and four processes ----------------------------------------------------

WORKER = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
inp, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
P_ = int(np.load(inp)["P"])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=P_,
                        timeout=datetime.timedelta(seconds=90))
sys.path.insert(0, ".")
import tests.test_torch_parallel_strategies as T
res = {}
for kind in ("dst", "uniform"):
    for key, a in zip(("out", "dx", "dw"), T._port_sharded(kind, P_, rank)):
        res[f"{kind}:{key}"] = a
res["feat:out"], res["feat:dx"] = T._port_feature(P_, rank)
for key, a in zip(("out", "dx", "dw"), T._port_expert(P_, rank)):
    res["expert:" + key] = a
for key, a in zip(("out", "dp", "dxm"), T._port_pipeline(P_, rank)):
    res["pipe:" + key] = a
dist.barrier()
dist.destroy_process_group()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "gammagl_tpu" or m.startswith("gammagl_tpu.")]
assert not bad, bad
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


def start_parts(tmp_path, P_, worker, **arrays):
    """Start ``worker`` in P_ gloo processes, as `_run_parts` of
    `tests/test_torch_halo_plan.py` runs them, and return at once (a
    handle for `finish_parts`), so the job runs while this process
    computes its references. Each process logs to a file."""
    inp = tmp_path / "in.npz"
    np.savez(inp, P=P_, **arrays)
    procs = []
    for r in range(P_):
        with open(tmp_path / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", worker, str(inp), str(r),
                 str(tmp_path / "store")], cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT))
    return tmp_path, procs, time.monotonic() + 240


def finish_parts(handle):
    """Wait for `start_parts`' processes (at most 240 s from their start)
    and return each part's results."""
    tmp_path, procs, deadline = handle
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {len(procs)} gloo workers did not finish in 240 s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, proc in enumerate(procs):
        assert proc.returncode == 0, \
            f"part {r}:\n{(tmp_path / f'log{r}.txt').read_text()}"
    return [dict(np.load(tmp_path / f"in_out{r}.npz"))
            for r in range(len(procs))]


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Both jobs (2 and 4 processes), started with the module."""
    return {P_: start_parts(tmp_path_factory.mktemp(f"strategies{P_}"), P_,
                            WORKER) for P_ in (2, 4)}


@pytest.fixture(scope="module", params=[2, 4])
def job(request, launched):
    P_ = request.param
    if not isinstance(launched[P_], list):
        launched[P_] = finish_parts(launched[P_])
    return P_, launched[P_]


def test_sharded_spmm_across_processes_matches_jax(job):
    P_, parts = job
    ei, w, x, _ = _graph()
    one = k.spmm_csr(torch.from_numpy(x), torch.from_numpy(w),
                     k.build_csr_plan(ei[0], ei[1], N)).numpy()
    for kind in ("dst", "uniform"):
        want, want_dx, want_dw = _jax_sharded(kind, P_)
        dw = np.zeros_like(want_dw)
        for r, part in enumerate(parts):
            _check(part[f"{kind}:out"], want)
            _check(part[f"{kind}:dx"], want_dx)
            own = part[f"{kind}:dw"]
            assert not np.delete(own, r, axis=0).any()  # on its owner only
            dw += own
            if kind == "dst":  # disjoint rows: bitwise one plan's sum
                np.testing.assert_array_equal(part["dst:out"], one)
        _check(dw, want_dw)


def test_feature_sharded_spmm_across_processes_matches_jax(job):
    P_, parts = job
    want, want_dx, ref = _jax_feature(P_)
    out = np.concatenate([p["feat:out"] for p in parts], 1)
    _check(out, want)
    _check(out, ref)
    _check(np.concatenate([p["feat:dx"] for p in parts], 1), want_dx)


def test_expert_spmm_across_processes_matches_jax(job):
    P_, parts = job
    _check_expert([(p["expert:out"], p["expert:dx"], p["expert:dw"])
                   for p in parts], P_)


def test_pipeline_across_processes_matches_jax(job):
    P_, parts = job
    _check_pipeline([(p["pipe:out"], p["pipe:dp"], p["pipe:dxm"])
                     for p in parts], P_)
