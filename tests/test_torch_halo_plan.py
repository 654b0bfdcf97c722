"""The port's planned halo tier (`gammagl_tpu_torch.parallel.halo_plan`)
and its accumulating SpMM (`spmm_csr_acc`) against the JAX package.

* The partition: the JAX partition's fields bit for bit (send_idx, sizes,
  R, ET, src_spans, the relabeling, the transpose's), the number of
  interior plans, and each part's plan of each class holding the same
  edges and weights as the JAX plan's unpadded lanes (functions, not
  layouts: the JAX plans are tiled for the TPU).
* The tier at one part, in this process: float32 against the JAX tier
  with ``kernel=True`` (Pallas in interpret mode, its f32 path drops a
  lo*lo term: 1e-4) and ``kernel=False`` (XLA: 1e-5), and the dense
  product; gradients against 2 A^T (A x); bf16 F = 256 against the JAX
  packed fold, both against an f32 reference of the bf16 inputs at
  rtol 2e-2 and each other at 3e-2 of max |out| (the JAX chain adds bf16
  partials, the port rounds once a block).
* `spmm_csr_acc_reference` against `segment_matmul_dyn_packed(out_acc=)`
  in interpret mode, bf16 F = 256, against an f32 reference at rtol 2e-2;
  rows without edges keep prev bitwise; E = 0.
* Two and four processes under gloo (CPU, no card) against the JAX tiers
  on as many virtual devices: forward and gradient of the planned and
  flat tiers. The workers import no JAX; they meet through a FileStore
  under the test's tmp_path (no port to collide on) and each is joined
  with a 120 s timeout.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu import parallel as jpar
from gammagl_tpu.ops.pallas import segment_matmul as jsm
from gammagl_tpu.parallel import halo_plan as jhp

from gammagl_tpu_torch import parallel as tpar
from gammagl_tpu_torch.ops import cuda as k

REPO = Path(__file__).resolve().parents[1]


def _graph(n=200, e=1600, seed=0, F=24):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, F)).astype(np.float32)
    return ei, w, x


def _empty_boundary():
    """Block-diagonal edges over 4 blocks of 16 rows: no boundary edge at
    2 or 4 parts without relabeling."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 16, 400) + (np.arange(400) % 4) * 16
    dst = (src // 16) * 16 + rng.integers(0, 16, 400)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    return np.stack([src, dst]), np.ones(400, np.float32), x


def _zipf_sources(n=512, e=20000, hub_rows=None, seed=0):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.35, e) - 1) % (hub_rows or n)
    dst = rng.integers(0, n, e)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return np.stack([src, dst]), np.ones(e, np.float32), x


def _dense(ei, w, n):
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (ei[1], ei[0]), w)
    return a


def _mesh(ndev):
    return Mesh(np.asarray(jax.devices()[:ndev]), ("dp",))


def _edges_of_port_plan(plan, w):
    rows = np.repeat(np.arange(plan.num_nodes), np.diff(plan.rowptr))
    return _sorted_edges(plan.col, rows, w)


def _edges_of_jax_stack(src, w, lr, tb, R):
    """(src, row, w) of the real lanes of one part's stacked JAX plan."""
    lr = lr.reshape(-1)
    rows = np.repeat(tb, lr.size // tb.size) * R + lr
    valid = lr < R
    return _sorted_edges(src[valid], rows[valid], w.reshape(-1)[valid])


def _sorted_edges(src, rows, w):
    order = np.lexsort((w, src, rows))
    return (np.asarray(src)[order].astype(np.int64),
            np.asarray(rows)[order].astype(np.int64),
            np.asarray(w)[order].astype(np.float32))


def _assert_same_partition(got, want):
    for field in ("send_idx", "num_parts", "rows_per", "halo_per_peer",
                  "num_nodes", "R", "ET", "src_spans", "node_perm",
                  "node_inv"):
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
    assert got.nblocks == want.nblocks
    jblocks = [(want.in_src, want.in_w, want.in_lr, want.in_tb)] + [
        blk[:4] for blk in want.in_extra]
    assert len(got.interior) == len(jblocks) == len(got.src_spans)
    for b, (src, w, lr, tb) in enumerate(jblocks):
        for p in range(got.num_parts):
            mine = _edges_of_port_plan(got.interior[b][p],
                                       got.interior_w[b][p])
            theirs = _edges_of_jax_stack(src[p], w[p], lr[p], tb[p], want.R)
            for a, c in zip(mine, theirs):
                np.testing.assert_array_equal(a, c)
    for p in range(got.num_parts):
        mine = _edges_of_port_plan(got.boundary[p], got.boundary_w[p])
        theirs = _edges_of_jax_stack(want.bd_src[p], want.bd_w[p],
                                     want.bd_lr[p], want.bd_tb[p], want.R)
        for a, c in zip(mine, theirs):
            np.testing.assert_array_equal(a, c)


PARTITION_CASES = {
    "uniform P=4": (lambda: _graph(), 4, 1, True, 16, 128),
    "uniform P=4 three blocks": (lambda: _graph(160, 1300, 13), 4, 3, True,
                                 8, 128),
    "flat vs planned P=8": (lambda: _graph(120, 900, 3), 8, 1, True, 8, 128),
    "empty boundary P=4": (_empty_boundary, 4, 1, False, 8, 128),
    "zipf sources P=1 four blocks": (_zipf_sources, 1, 4, True, 16, 64),
    "hub on part 0 P=4 four blocks": (
        lambda: _zipf_sources(e=24000, hub_rows=128, seed=1), 4, 4, False,
        16, 64),
}


@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_partition_matches_jax(case):
    make, P_, nsb, balance, R, ET = PARTITION_CASES[case]
    ei, w, x = make()
    n = x.shape[0]
    want = jpar.build_halo_partition_planned(ei, n, P_, w, R=R, ET=ET,
                                             num_src_blocks=nsb,
                                             balance=balance)
    got = tpar.build_halo_partition_planned(ei, n, P_, w, R=R, ET=ET,
                                            num_src_blocks=nsb,
                                            balance=balance)
    _assert_same_partition(got, want)
    _assert_same_partition(got.transpose, want.transpose)
    assert got.transpose.transpose is None


@pytest.mark.parametrize("rows,F,dtype", [
    (2_000_000, 128, "f32"), (1_110_600, 256, "bf16"), (222_112, 256, "bf16"),
    (100, 8, "f32"), (47_185_920, 1, "bf16")])
def test_auto_src_blocks_matches_jax(rows, F, dtype):
    jd, td = ((np.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    assert tpar.auto_src_blocks(rows, F, td) == jhp.auto_src_blocks(
        rows, F, jd) == tpar.auto_src_blocks(rows, F, jd)
    # the papers shard at 1% of papers100M: 7 source blocks
    assert tpar.auto_src_blocks(1_110_599, 256, torch.bfloat16) == 7


def _jax_tier(ei, w, x, n, P_, nsb, kernel=True, dtype=jnp.float32, R=8,
              ET=128, balance=True, grad=True):
    part = jpar.build_halo_partition_planned(ei, n, P_, w, R=R, ET=ET,
                                             num_src_blocks=nsb,
                                             balance=balance)
    mesh = _mesh(P_)
    xs = jax.device_put(jnp.asarray(jpar.pad_nodes(x, part), dtype),
                        NamedSharding(mesh, P("dp")))
    spmm = jpar.make_halo_spmm_planned(mesh, part, kernel=kernel)
    out = np.asarray(jax.jit(spmm)(xs).astype(jnp.float32))
    if not grad:
        return out, None
    g = jax.jit(jax.grad(
        lambda v: jnp.sum(spmm(v).astype(jnp.float32) ** 2)))(xs)
    return out, np.asarray(g.astype(jnp.float32))


def _port_tier(ei, w, x, n, nsb, dtype=torch.float32, kernel=True, R=8,
               ET=128):
    part = tpar.build_halo_partition_planned(ei, n, 1, w, R=R, ET=ET,
                                             num_src_blocks=nsb)
    xt = tpar.shard_nodes(x, part, device="cpu", dtype=dtype)
    xt.requires_grad_()
    out = tpar.make_halo_spmm_planned(part, kernel=kernel)(xt)
    (out.float() ** 2).sum().backward()
    return part, out.detach().float().numpy(), xt.grad.float().numpy()


@pytest.mark.parametrize("nsb", [1, 3])
def test_planned_tier_one_part_matches_jax(nsb):
    n = 160
    ei, w, x = _graph(n, 1300, 13)
    part, out, grad = _port_tier(ei, w, x, n, nsb)
    assert out.shape == (part.rows_per, 24)
    assert len(part.interior) >= nsb
    want_k, grad_k = _jax_tier(ei, w, x, n, 1, nsb, kernel=True)
    want_x, grad_x = _jax_tier(ei, w, x, n, 1, nsb, kernel=False)
    np.testing.assert_allclose(out, want_k, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, want_x, rtol=1e-5, atol=1e-5)
    a = _dense(ei, w, n)
    np.testing.assert_allclose(tpar.unpad_nodes(out, part), a @ x,
                               rtol=1e-4, atol=1e-4)
    ref_g = 2 * a.T @ (a @ x)
    np.testing.assert_allclose(tpar.unpad_nodes(grad, part), ref_g,
                               rtol=2e-3, atol=2e-3)
    scale = np.abs(grad_x).max()
    np.testing.assert_allclose(grad, grad_x, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(grad, grad_k, rtol=1e-4, atol=1e-4 * scale)


def test_kernel_false_takes_the_plain_versions():
    n = 160
    ei, w, x = _graph(n, 1300, 14)
    _, out, grad = _port_tier(ei, w, x, n, 3, kernel=False)
    _, out_k, grad_k = _port_tier(ei, w, x, n, 3, kernel=True)
    np.testing.assert_array_equal(out, out_k)
    np.testing.assert_array_equal(grad, grad_k)


def test_planned_tier_bf16_matches_the_jax_packed_fold(monkeypatch):
    monkeypatch.setattr(jhp, "_PACKED_HALO", True)
    n = 96
    ei, w, x = _graph(n, 900, 23, F=256)
    part, out, grad = _port_tier(ei, w, x, n, 3, dtype=torch.bfloat16)
    assert len(part.interior) >= 3
    want, want_g = _jax_tier(ei, w, x, n, 1, 3, dtype=jnp.bfloat16)
    xd = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float64)
    a = _dense(ei, w, n)
    ref = a @ xd
    for got in (out, want):
        np.testing.assert_allclose(tpar.unpad_nodes(got, part), ref,
                                   rtol=2e-2, atol=2e-2 * np.abs(ref).max())
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    ref_g = 2 * a.T @ ref
    for got in (grad, want_g):
        np.testing.assert_allclose(tpar.unpad_nodes(got, part), ref_g,
                                   rtol=5e-2, atol=3e-2 * np.abs(ref_g).max())


def test_gradient_is_twice_the_transpose_of_the_product():
    n = 120
    ei, w, x = _graph(n, 1000, 31)
    part, out, grad = _port_tier(ei, w, x, n, 2)
    a = _dense(ei, w, n)
    np.testing.assert_allclose(tpar.unpad_nodes(grad, part),
                               2 * a.T @ (a @ x), rtol=1e-4, atol=1e-4)


def _acc_case(seed, e, n_dst=40, n_src=56, F=256):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, e)
    dst = rng.integers(0, n_dst - 9, e)  # the last 9 rows: no edges
    w = rng.normal(size=e).astype(np.float32)
    x = np.asarray(jnp.asarray(rng.normal(size=(n_src, F)), jnp.bfloat16),
                   np.float32)
    prev = np.asarray(jnp.asarray(rng.normal(size=(n_dst, F)),
                                  jnp.bfloat16), np.float32)
    return src, dst, w, x, prev


@pytest.mark.parametrize("e", [300, 0])
def test_spmm_csr_acc_reference_matches_the_jax_packed_kernel(e):
    n_dst, n_src, R, ET = 40, 56, 8, 64
    src, dst, w, x, prev = _acc_case(7, e)
    jplan = jsm.build_csr_plan(src, dst, n_dst, num_src=n_src, R=R, ET=ET)
    nblocks = -(-n_dst // R)
    w_pad = jhp._permute_w(w, jplan)
    g = jnp.take(jsm.pack_halves(jnp.asarray(x, jnp.bfloat16)),
                 jnp.asarray(jplan.src_pad), axis=0)
    prev_pad = jnp.zeros((nblocks * R, 256), jnp.bfloat16).at[:n_dst].set(
        jnp.asarray(prev, jnp.bfloat16))
    want = np.asarray(jsm.segment_matmul_dyn_packed(
        g, jnp.asarray(w_pad), jnp.asarray(jplan.local_row),
        jnp.asarray(jplan.tile_block), jnp.asarray(jplan.tile_first),
        R=R, ET=ET, nblocks=nblocks, interpret=True,
        out_acc=prev_pad)[:n_dst].astype(jnp.float32))
    plan = k.build_csr_plan(src, dst, n_dst, num_src=n_src)
    prev_t = torch.from_numpy(prev).to(torch.bfloat16)
    got = k.spmm_csr_acc_reference(torch.from_numpy(x).to(torch.bfloat16),
                                   torch.from_numpy(w), plan,
                                   prev=prev_t).float().numpy()
    ref = prev.astype(np.float64) + _dense(np.stack([src, dst]), w, max(
        n_dst, n_src))[:n_dst, :n_src] @ x.astype(np.float64)
    for out in (got, want):
        np.testing.assert_allclose(out, ref, rtol=2e-2,
                                   atol=2e-2 * np.abs(ref).max())
    bare = np.bincount(dst, minlength=n_dst) == 0
    assert bare[-9:].all()
    np.testing.assert_array_equal(got[bare], prev[bare])
    np.testing.assert_array_equal(want[bare], prev[bare])
    if e == 0:
        np.testing.assert_array_equal(got, prev)


def test_spmm_csr_acc_checks_and_writes_in_place():
    src, dst, w, x, prev = _acc_case(8, 200, F=16)
    plan = k.build_csr_plan(src, dst, 40, num_src=56)
    xt, wt, pt = (torch.from_numpy(a) for a in (x, w, prev))
    want = k.spmm_csr_acc_reference(xt, wt, plan, prev=pt)
    np.testing.assert_allclose(
        want.numpy(), prev + (k.spmm_csr(xt, wt, plan)).numpy(), rtol=1e-5,
        atol=1e-5)
    out = pt.clone()
    assert k.spmm_csr_acc(xt, wt, plan, prev=out, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert torch.equal(k.spmm_csr_acc(xt, wt, plan),
                       k.spmm_csr(xt, wt, plan))
    with pytest.raises(ValueError, match="prev must be"):
        k.spmm_csr_acc(xt, wt, plan, prev=pt[:10])
    with pytest.raises(ValueError, match="prev must be"):
        k.spmm_csr_acc(xt, wt, plan, prev=pt.double())
    with pytest.raises(RuntimeError, match="not differentiable"):
        k.spmm_csr_acc(xt.requires_grad_(), wt, plan, prev=pt)
    with torch.no_grad():
        k.spmm_csr_acc(xt, wt, plan, prev=pt)


def test_tier_backward_rules():
    n = 80
    ei, w, x = _graph(n, 600, 41)
    part = tpar.build_halo_partition_planned(ei, n, 1, w, R=8, ET=128)
    xt = tpar.shard_nodes(x, part, device="cpu").requires_grad_()
    out = tpar.make_halo_spmm_planned(part)(xt)
    gx, = torch.autograd.grad(out.sum(), xt, create_graph=False)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(tpar.make_halo_spmm_planned(part)(xt).sum(), xt,
                            create_graph=True)
    no_t = part._replace(transpose=None)
    with pytest.raises(RuntimeError, match="with_transpose=False"):
        tpar.make_halo_spmm_planned(no_t)(xt).sum().backward()
    with pytest.raises(ValueError, match="with_transpose=True"):
        tpar.make_halo_spmm_planned_pair(no_t)
    spmm, spmm_t = tpar.make_halo_spmm_planned_pair(part)
    np.testing.assert_array_equal(spmm(xt).numpy(), out.detach().numpy())
    ones = torch.ones_like(out)
    np.testing.assert_array_equal(spmm_t(ones).numpy(), gx.numpy())
    with pytest.raises(ValueError, match="block"):
        spmm(xt[:10])


WORKER = r"""
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
n, nsb, bal = int(d["n"]), int(d["nsb"]), bool(d["balance"])
planned = tpar.build_halo_partition_planned(d["ei"], n, P_, d["w"], R=8,
                                            ET=128, num_src_blocks=nsb,
                                            balance=bal)
flat = tpar.build_halo_partition(d["ei"], n, P_, d["w"], balance=bal)
res = {}
for name, part, make in (("planned", planned, tpar.make_halo_spmm_planned),
                         ("flat", flat, tpar.make_halo_spmm)):
    x = tpar.shard_nodes(d["x"], part, device="cpu").requires_grad_()
    out = make(part)(x)
    (out ** 2).sum().backward()
    res[name + "_out"] = out.detach().numpy()
    res[name + "_grad"] = x.grad.numpy()
dist.barrier()
dist.destroy_process_group()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "gammagl_tpu" or m.startswith("gammagl_tpu.")]
assert not bad, bad
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


def _run_parts(tmp_path, P_, worker=WORKER, **arrays):
    """Run ``worker`` in P_ processes under gloo; each part's results."""
    inp = tmp_path / "in.npz"
    np.savez(inp, P=P_, **arrays)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(inp), str(r),
         str(tmp_path / "store")], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(P_)]
    deadline = time.monotonic() + 120
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {P_} gloo workers did not finish in 120 s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"part {r}:\n{log}"
    return [dict(np.load(tmp_path / f"in_out{r}.npz")) for r in range(P_)]


@pytest.mark.parametrize("P_", [2, 4])
@pytest.mark.parametrize("graph", ["random", "empty boundary"])
def test_tiers_across_processes_match_jax(tmp_path, P_, graph):
    if graph == "random":
        ei, w, x = _graph(200, 1600, 0)
        nsb, balance = 3, True
    else:
        ei, w, x = _empty_boundary()
        nsb, balance = 1, False
    n = x.shape[0]
    parts = _run_parts(tmp_path, P_, ei=ei, w=w, x=x, n=n, nsb=nsb,
                       balance=balance)
    got = {key: np.concatenate([p[key] for p in parts])
           for key in parts[0]}
    want, want_g = _jax_tier(ei, w, x, n, P_, nsb, balance=balance)
    np.testing.assert_allclose(got["planned_out"], want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["planned_grad"], want_g, rtol=1e-4,
                               atol=1e-4 * np.abs(want_g).max())
    jflat = jpar.build_halo_partition(ei, n, P_, w, balance=balance)
    mesh = _mesh(P_)
    xs = jax.device_put(jnp.asarray(jpar.pad_nodes(x, jflat)),
                        NamedSharding(mesh, P("dp")))
    spmm = jpar.make_halo_spmm(mesh, jflat)
    np.testing.assert_allclose(got["flat_out"], np.asarray(jax.jit(spmm)(xs)),
                               rtol=1e-5, atol=1e-5)
    flat_g = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(spmm(v) ** 2)))(xs))
    np.testing.assert_allclose(got["flat_grad"], flat_g, rtol=1e-5,
                               atol=1e-5 * np.abs(flat_g).max())
    part = tpar.build_halo_partition_planned(ei, n, P_, w, R=8, ET=128,
                                             num_src_blocks=nsb,
                                             balance=balance)
    a = _dense(ei, w, n)
    np.testing.assert_allclose(tpar.unpad_nodes(got["planned_out"], part),
                               a @ x, rtol=1e-4, atol=1e-4)
    if graph == "empty boundary":
        assert all(pl.num_edges == 0 for pl in part.boundary)
