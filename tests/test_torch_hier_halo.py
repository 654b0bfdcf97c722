"""The port's two-level halo tiers (`gammagl_tpu_torch.parallel.hier_halo`
and the planned two-level tier of `parallel.halo_plan`), its process grid
(`parallel.mesh.hier_world`) and `parallel.scaling` against the JAX
package.

* The partitions: every `HierHaloPartition` field bit for bit, with and
  without the balanced relabeling, on (2, 2), (2, 3), (3, 2), (4, 1),
  (1, 4) and (1, 1) grids and on a graph whose edges stay inside slices;
  each part's interior, intra and inter plans holding the JAX plans'
  edges and weights (as sets: the JAX plans are tiled for the TPU), the
  transpose's too; `traffic_report`'s dict.
* Both tiers at (1, 1) in this process: float32 against the JAX tiers
  (planned: XLA at 1e-5, Pallas in interpret mode at 1e-4), bf16 against
  an f32 reference of the same inputs at rtol 2e-2 and the JAX bf16 tier
  at 3e-2 of max |out|.
* Four gloo processes (CPU) against the JAX tiers on a virtual
  ``Mesh(devices[:4].reshape(S, D), ('slice', 'dp'))``: both tiers'
  forward and x's gradient at (2, 2) in f32 and bf16 (planned against the
  Pallas path), at (4, 1) and (1, 4) (an axis of one process), on a graph
  whose edges stay inside slices (the inter class empty), and the GCN
  recipes on the (2, 2) planned partition: 3 losses against JAX's
  `make_partitioned_gcn_train` on it (1e-4), w0 and the logits after them
  against that recipe on the two-level XLA tier (1e-4), and the step-0
  gradients against ``jax.grad`` of the same model on the planned XLA
  tier (1e-5). Six processes at
  (2, 3), where S != D, hold the inter table's ``[d_owner, s, pos]``
  order. The workers import no JAX.
* The papers twin with ``--rcm`` (f32) at one part (``--slices 1``) and
  in the four processes with ``--slices 2`` against the JAX recipe as its
  twin runs it (1e-4); ``--slices 2`` without a process group raises.
* `halo_scaling_estimate` against JAX's on JAX's `V5E` fields.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu import parallel as jpar
from gammagl_tpu.parallel import scaling as jscaling
from gammagl_tpu.utils import calc_gcn_norm_np as jnorm

from gammagl_tpu_torch import parallel as tpar
from gammagl_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_halo_plan import (_dense, _edges_of_jax_stack,
                                        _edges_of_port_plan, _graph,
                                        _run_parts)


def _in_slice_graph(seed=5, n=64, e=600):
    """Edges whose endpoints share a slice of a (2, 2) grid in the natural
    order (rows_per 16: slice 0 owns rows 0-31, slice 1 rows 32-63)."""
    rng = np.random.default_rng(seed)
    sl = rng.integers(0, 2, e)
    src = sl * 32 + rng.integers(0, 32, e)
    dst = sl * 32 + rng.integers(0, 32, e)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, 24)).astype(np.float32)
    return np.stack([src, dst]), w, x


GRIDS = {"(2, 2)": (2, 2), "(2, 3)": (2, 3), "(3, 2)": (3, 2),
         "(4, 1)": (4, 1), "(1, 4)": (1, 4), "(1, 1)": (1, 1)}


def _assert_same_base(got, want):
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
            assert np.asarray(a).dtype == np.asarray(b).dtype, field


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_partition_fields_are_jax_bit_for_bit(grid, balance):
    S, D = GRIDS[grid]
    ei, w, _ = _graph(200, 1600, 0)
    want = jpar.build_hier_halo_partition(ei, 200, S, D, w, balance=balance)
    got = tpar.build_hier_halo_partition(ei, 200, S, D, w, balance=balance)
    _assert_same_base(got, want)
    assert got.num_parts == S * D


def test_in_slice_graph_has_no_inter_rows():
    ei, w, _ = _in_slice_graph()
    want = jpar.build_hier_halo_partition(ei, 64, 2, 2, w, balance=False)
    got = tpar.build_hier_halo_partition(ei, 64, 2, 2, w, balance=False)
    _assert_same_base(got, want)
    assert got.inter_rows == got.inter_rows_flat == 0 < got.intra_rows


def _assert_same_classes(got, want):
    S, D = got.num_slices, got.dp_per_slice
    _assert_same_base(got.base, want.base)
    for name, key in (("interior", "in"), ("intra", "ia"), ("inter", "ir")):
        plans, ws = getattr(got, name), getattr(got, name + "_w")
        src, w, lr, tb = (getattr(want, f"{key}_{f}")
                          for f in ("src", "w", "lr", "tb"))
        for s in range(S):
            for d in range(D):
                r = s * D + d
                mine = _edges_of_port_plan(plans[r], ws[r])
                theirs = _edges_of_jax_stack(src[s, d], w[s, d], lr[s, d],
                                             tb[s, d], want.R)
                for a, c in zip(mine, theirs):
                    np.testing.assert_array_equal(a, c, err_msg=name)


@pytest.mark.parametrize("case", ["(2, 2) balanced", "(2, 3)",
                                  "(1, 1)", "in-slice (2, 2)"])
def test_planned_partition_classes_match_jax(case):
    if case == "in-slice (2, 2)":
        ei, w, x = _in_slice_graph()
        S, D, balance = 2, 2, False
    else:
        ei, w, x = _graph(160, 1300, 13)
        S, D = GRIDS[case.split(" b")[0]]
        balance = case != "(2, 3)"
    n = x.shape[0]
    want = jpar.build_hier_halo_partition_planned(ei, n, S, D, w, R=8, ET=128,
                                                  balance=balance)
    got = tpar.build_hier_halo_partition_planned(ei, n, S, D, w, R=8, ET=128,
                                                 balance=balance)
    _assert_same_classes(got, want)
    _assert_same_classes(got.transpose, want.transpose)
    for field in ("node_perm", "node_inv"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None) == (not balance or S * D == 1)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    assert got.transpose.transpose is None
    assert (got.num_slices, got.dp_per_slice, got.num_parts, got.rows_per,
            got.num_nodes) == (
        want.num_slices, want.dp_per_slice, want.num_parts, want.rows_per,
        want.num_nodes)
    if case == "in-slice (2, 2)":
        assert all(p.num_edges == 0 for p in got.inter)
        assert all(p.num_edges > 0 for p in got.intra)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("F", [24, 256])
def test_traffic_report_matches_jax(F, dtype):
    ei, w, _ = _graph(200, 1600, 0)
    part = tpar.build_hier_halo_partition(ei, 200, 2, 2, w)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    want = jpar.traffic_report(
        jpar.build_hier_halo_partition(ei, 200, 2, 2, w), F, jd)
    assert tpar.traffic_report(part, F, td) == want
    assert tpar.traffic_report(part, F, jd) == want
    assert want["dcn_dedup_factor"] > 1


def _hmesh(S, D):
    return Mesh(np.asarray(jax.devices()[:S * D]).reshape(S, D),
                ("slice", "dp"))


def _jax_hier(ei, w, x, S, D, tier, dtype=jnp.float32, kernel=False,
              balance=True):
    """(out, x's gradient of sum(out**2)) of a JAX two-level tier, padded
    and in the partition's order, float32 numpy."""
    n = x.shape[0]
    mesh = _hmesh(S, D)
    if tier == "planned":
        part = jpar.build_hier_halo_partition_planned(
            ei, n, S, D, w, R=8, ET=128, balance=balance)
        spmm = jpar.make_hier_halo_spmm_planned(mesh, part, kernel=kernel)
    else:
        part = jpar.build_hier_halo_partition(ei, n, S, D, w,
                                              balance=balance)
        spmm = jpar.make_hier_halo_spmm(mesh, part)
    xs = jax.device_put(jnp.asarray(jpar.pad_nodes(x, part), dtype),
                        NamedSharding(mesh, P(("slice", "dp"))))
    def loss(v):
        out = spmm(v).astype(jnp.float32)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(xs)
    return np.asarray(out), np.asarray(g.astype(jnp.float32))


def _port_one_part(ei, w, x, tier, dtype):
    n = x.shape[0]
    if tier == "planned":
        part = tpar.build_hier_halo_partition_planned(ei, n, 1, 1, w, R=8,
                                                      ET=128)
        make = tpar.make_hier_halo_spmm_planned
    else:
        part = tpar.build_hier_halo_partition(ei, n, 1, 1, w)
        make = tpar.make_hier_halo_spmm
    xt = tpar.shard_nodes(x, part, device="cpu", dtype=dtype)
    xt.requires_grad_()
    out = make(part)(xt)
    (out.float() ** 2).sum().backward()
    return part, out.detach().float().numpy(), xt.grad.float().numpy()


@pytest.mark.parametrize("tier", ["planned", "flat"])
def test_tiers_at_one_part_match_jax_f32(tier):
    n = 160
    ei, w, x = _graph(n, 1300, 13)
    part, out, grad = _port_one_part(ei, w, x, tier, torch.float32)
    want, want_g = _jax_hier(ei, w, x, 1, 1, tier)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, want_g, rtol=1e-5, atol=1e-5 * scale)
    if tier == "planned":
        want_k, want_kg = _jax_hier(ei, w, x, 1, 1, tier, kernel=True)
        np.testing.assert_allclose(out, want_k, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(grad, want_kg, rtol=1e-4,
                                   atol=1e-4 * scale)
    a = _dense(ei, w, n)
    np.testing.assert_allclose(tpar.unpad_nodes(out, part), a @ x,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tier", ["planned", "flat"])
def test_tiers_at_one_part_bf16(tier):
    n = 96
    ei, w, x = _graph(n, 900, 23, F=256)
    part, out, grad = _port_one_part(ei, w, x, tier, torch.bfloat16)
    want, want_g = _jax_hier(ei, w, x, 1, 1, tier, dtype=jnp.bfloat16,
                             kernel=tier == "planned")
    a = _dense(ei, w, n)
    ref = a @ np.asarray(jnp.asarray(x, jnp.bfloat16), np.float64)
    for got in (out, want):
        np.testing.assert_allclose(tpar.unpad_nodes(got, part), ref,
                                   rtol=2e-2, atol=2e-2 * np.abs(ref).max())
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    np.testing.assert_allclose(grad, want_g, rtol=0,
                               atol=3e-2 * np.abs(want_g).max())


def test_grid_rules():
    assert tpar.hier_world(1, 1) == tmesh.HierGrid(0, 0, None, None, None,
                                                   1, 1)
    assert tpar.hier_world(1, 1).rank == 0
    with pytest.raises(RuntimeError, match="world size 4"):
        tpar.hier_world(2, 2)
    with pytest.raises(ValueError, match="0 x 2"):
        tpar.hier_world(0, 2)
    grid = tpar.hier_world(1, 1)
    assert tpar.hier_world(1, 1, grid) is grid
    with pytest.raises(ValueError, match="the grid given is 1 x 1"):
        tpar.hier_world(2, 1, grid)
    ei, w, x = _graph(80, 600, 41)
    part = tpar.build_hier_halo_partition_planned(ei, 80, 2, 2, w)
    with pytest.raises(RuntimeError, match="world size 4"):
        tpar.make_hier_halo_spmm_planned(part)
    with pytest.raises(RuntimeError, match="world size 4"):
        tpar.make_hier_halo_spmm(part.base)
    one = tpar.build_hier_halo_partition_planned(ei, 80, 1, 1, w)
    with pytest.raises(ValueError, match="with_transpose=True"):
        tpar.make_hier_halo_spmm_planned_pair(one._replace(transpose=None))
    spmm, spmm_t = tpar.make_hier_halo_spmm_planned_pair(one)
    xt = tpar.shard_nodes(x, one, device="cpu")
    with pytest.raises(ValueError, match="block"):
        spmm(xt[:10])
    a = _dense(ei, w, 80)
    np.testing.assert_allclose(tpar.unpad_nodes(spmm_t(xt), one), a.T @ x,
                               rtol=1e-5, atol=1e-5)


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
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
res = {}
grids = {}
for job in [str(j) for j in d["jobs"]]:
    g, S, D, tier, dt, bal = job.split(":")
    S, D = int(S), int(D)
    if (S, D) not in grids:
        grids[(S, D)] = tpar.hier_world(S, D)
    ei, w, x = d[g + "_ei"], d[g + "_w"], d[g + "_x"]
    n = x.shape[0]
    if tier == "planned":
        part = tpar.build_hier_halo_partition_planned(
            ei, n, S, D, w, R=8, ET=128, balance=bal == "1")
        spmm = tpar.make_hier_halo_spmm_planned(part, grids[(S, D)])
    else:
        part = tpar.build_hier_halo_partition(ei, n, S, D, w,
                                              balance=bal == "1")
        spmm = tpar.make_hier_halo_spmm(part, grids[(S, D)])
    xb = tpar.shard_nodes(x, part, device="cpu", dtype=DT[dt])
    xb.requires_grad_()
    out = spmm(xb)
    (out.float() ** 2).sum().backward()
    res[job + ":out"] = out.detach().float().numpy()
    res[job + ":grad"] = xb.grad.float().numpy()
if "gcn_x" in d:
    part = tpar.build_hier_halo_partition_planned(
        d["gcn_ei"], d["gcn_x"].shape[0], 2, 2, d["gcn_w"], R=16, ET=128)
    for recipe in ("staged", "monolithic"):
        build = (tpar.make_partitioned_gcn_train_staged
                 if recipe == "staged" else tpar.make_partitioned_gcn_train)
        params, opt, step, ev = build(part, d["gcn_x"].shape[1], 16,
                                      int(d["gcn_c"]), num_layers=3,
                                      compute_dtype=torch.float32,
                                      learning_rate=5e-2, device="cpu",
                                      group=grids[(2, 2)])
        xs, ys, ms = (tpar.shard_nodes(d["gcn_" + k], part, device="cpu")
                      for k in ("x", "y", "mask"))
        _, grads = step.loss_and_grads(params, xs, ys, ms)
        for k_, v in grads.items():
            res[f"{recipe}:grad:{k_}"] = v.numpy()
        losses = []
        for _ in range(3):
            params, opt, loss = step(params, opt, xs, ys, ms)
            losses.append(float(loss))
        res[recipe + ":losses"] = np.asarray(losses)
        res[recipe + ":logits"] = ev(params, xs).numpy()
        res[recipe + ":w0"] = params["w0"].detach().numpy()
if "twin_argv" in d:
    from gammagl_tpu_torch.examples import papers100m_trainer as twin
    out = twin.main(twin.parser().parse_args([str(a) for a in
                                              d["twin_argv"]]))
    res["twin:losses"] = np.asarray(out["losses"])
    res["twin:parts"] = np.asarray([out["parts"], out["slices"]])
dist.barrier()
dist.destroy_process_group()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "gammagl_tpu" or m.startswith("gammagl_tpu.")]
assert not bad, bad
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


def _gcn_graph():
    from tests.test_torch_full_graph import _graph as gcn_graph
    return gcn_graph(seed=4)


FOUR_JOBS = ["rand:2:2:planned:f32:1", "rand:2:2:planned:bf16:1",
             "rand:2:2:flat:f32:1", "rand:2:2:flat:bf16:1",
             "slice:2:2:planned:f32:0", "slice:2:2:flat:f32:0",
             "rand:4:1:planned:f32:1", "rand:4:1:flat:f32:1",
             "rand:1:4:planned:f32:1", "rand:1:4:flat:f32:1"]
SIX_JOBS = ["rand:2:3:planned:f32:1", "rand:2:3:flat:f32:0"]


def _graphs():
    ei, w, x = _graph(200, 1600, 0)
    sei, sw, sx = _in_slice_graph()
    return {"rand": (ei, w, x), "slice": (sei, sw, sx)}


def _arrays(graphs):
    return {f"{g}_{k}": a for g, arrs in graphs.items()
            for k, a in zip(("ei", "w", "x"), arrs)}


@pytest.fixture(scope="module")
def four_parts(tmp_path_factory):
    gei, gw, gx, gy, gmask, gc = _gcn_graph()
    parts = _run_parts(tmp_path_factory.mktemp("hier4"), 4, worker=WORKER,
                       jobs=np.asarray(FOUR_JOBS), **_arrays(_graphs()),
                       gcn_ei=gei, gcn_w=gw, gcn_x=gx, gcn_y=gy,
                       gcn_mask=gmask, gcn_c=gc,
                       twin_argv=np.asarray(TWIN_ARGV + ["--slices", "2"]))
    return {key: np.concatenate([p[key] for p in parts])
            if key.endswith((":out", ":grad", ":logits")) else
            [p[key] for p in parts] for key in parts[0]}


@pytest.fixture(scope="module")
def six_parts(tmp_path_factory):
    parts = _run_parts(tmp_path_factory.mktemp("hier6"), 6, worker=WORKER,
                       jobs=np.asarray(SIX_JOBS), **_arrays(_graphs()))
    return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


def _check_job(got, job, kernel=False):
    g, S, D, tier, dt, bal = job.split(":")
    ei, w, x = _graphs()[g]
    jd = jnp.bfloat16 if dt == "bf16" else jnp.float32
    want, want_g = _jax_hier(ei, w, x, int(S), int(D), tier, jd,
                             kernel=kernel, balance=bal == "1")
    out, grad = got[job + ":out"], got[job + ":grad"]
    scale = np.abs(want_g).max()
    if dt == "bf16":
        np.testing.assert_allclose(out, want, rtol=0,
                                   atol=3e-2 * np.abs(want).max())
        np.testing.assert_allclose(grad, want_g, rtol=0, atol=3e-2 * scale)
        want32, _ = _jax_hier(ei, w, np.asarray(
            jnp.asarray(x, jnp.bfloat16), np.float32), int(S), int(D), tier,
            balance=bal == "1")
        np.testing.assert_allclose(out, want32, rtol=2e-2,
                                   atol=2e-2 * np.abs(want32).max())
    else:
        tol = 1e-4 if kernel else 1e-5
        np.testing.assert_allclose(out, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(grad, want_g, rtol=tol,
                                   atol=tol * scale)
    n = x.shape[0]
    part = tpar.build_hier_halo_partition(ei, n, int(S), int(D), w,
                                          balance=bal == "1")
    np.testing.assert_allclose(tpar.unpad_nodes(out, part),
                               _dense(ei, w, n) @ x, rtol=2e-2 if
                               dt == "bf16" else 1e-4, atol=2e-2 * np.abs(
                                   want).max() if dt == "bf16" else 1e-4)


@pytest.mark.parametrize("job", [j for j in FOUR_JOBS if ":2:2:" in j
                                 and j.startswith("rand")])
def test_tiers_at_2x2_match_jax(four_parts, job):
    _check_job(four_parts, job, kernel=":planned:" in job)


@pytest.mark.parametrize("job", [j for j in FOUR_JOBS
                                 if j.startswith("slice")])
def test_in_slice_graph_across_processes_matches_jax(four_parts, job):
    _check_job(four_parts, job)


@pytest.mark.parametrize("job", [j for j in FOUR_JOBS
                                 if ":4:1:" in j or ":1:4:" in j])
def test_degenerate_grids_match_jax(four_parts, job):
    _check_job(four_parts, job)


@pytest.mark.parametrize("job", SIX_JOBS)
def test_tiers_at_2x3_match_jax(six_parts, job):
    _check_job(six_parts, job)


def _jax_recipe(tier):
    """JAX's monolithic recipe on the (2, 2) two-level partition of
    ``tier``: its 3 losses, and the logits and w0 after them."""
    ei, w, x, y, mask, c = _gcn_graph()
    n = x.shape[0]
    mesh = _hmesh(2, 2)
    if tier == "planned":
        jpart = jpar.build_hier_halo_partition_planned(ei, n, 2, 2, w, R=16,
                                                       ET=128)
    else:
        jpart = jpar.build_hier_halo_partition(ei, n, 2, 2, w)
    params, opt_state, step, ev = jpar.make_partitioned_gcn_train(
        mesh, jpart, x.shape[1], 16, c, num_layers=3,
        compute_dtype=jnp.float32, learning_rate=5e-2)
    ax = ("slice", "dp")
    xs, ys, ms = (jpar.shard_nodes(a, mesh, jpart, axis=ax)
                  for a in (x, y, mask))
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    return (losses, np.asarray(ev(params, xs)), np.asarray(params["w0"]),
            jpart, mesh, xs, ys, ms, params)


@functools.lru_cache(maxsize=None)
def _jax_gcn():
    """The JAX references of the GCN recipes on the (2, 2) planned
    partition: the planned recipe's 3 losses (its tier is the Pallas path
    in interpret mode, whose bf16x3 products move a ReLU input near 0 to
    the other side within 3 Adam steps), the logits and w0 after 3 steps
    of the same recipe on the two-level XLA tier (the same partition of
    the nodes), and the step-0 gradients of the model, `jax.grad` of the
    recipe's forward and loss on the planned XLA tier."""
    losses, *_ = _jax_recipe("planned")
    _, logits, w0, *_ = _jax_recipe("flat")
    ei, w, x, y, mask, c = _gcn_graph()
    n = x.shape[0]
    mesh = _hmesh(2, 2)
    jpart = jpar.build_hier_halo_partition_planned(ei, n, 2, 2, w, R=16,
                                                   ET=128)
    params, *_ = jpar.make_partitioned_gcn_train(
        mesh, jpart, x.shape[1], 16, c, num_layers=3,
        compute_dtype=jnp.float32)
    ax = ("slice", "dp")
    xs, ys, ms = (jpar.shard_nodes(a, mesh, jpart, axis=ax)
                  for a in (x, y, mask))
    spmm = jpar.make_hier_halo_spmm_planned(mesh, jpart, kernel=False)

    def loss_fn(p):
        h = xs
        for i in range(3):
            h = spmm(h) @ p[f"w{i}"] + p[f"b{i}"]
            if i < 2:
                h = jax.nn.relu(h)
        ls = optax.softmax_cross_entropy_with_integer_labels(h, ys)
        return (ls * ms).sum() / jnp.maximum(ms.sum(), 1.0)

    grads = {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss_fn))(
        params).items()}
    return grads, losses, logits, w0


@pytest.mark.parametrize("recipe", ["staged", "monolithic"])
def test_gcn_recipes_on_the_2x2_planned_partition_match_jax(four_parts,
                                                           recipe):
    grads, losses, logits, w0 = _jax_gcn()
    for r in range(4):
        for key, want in grads.items():
            got = four_parts[f"{recipe}:grad:{key}"][r]
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
        np.testing.assert_allclose(four_parts[recipe + ":losses"][r],
                                   losses, rtol=1e-4)
        np.testing.assert_array_equal(four_parts[recipe + ":w0"][r],
                                      four_parts[recipe + ":w0"][0])
    np.testing.assert_allclose(four_parts[recipe + ":w0"][0], w0,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(four_parts[recipe + ":logits"], logits,
                               rtol=1e-4, atol=1e-4 * np.abs(logits).max())


TWIN_ARGV = ["--device", "cpu", "--scale", "0.00002", "--epochs", "3",
             "--f32", "--rcm", "--hidden", "32"]


@functools.lru_cache(maxsize=None)
def _jax_twin(S, D):
    """JAX's recipe as its papers twin runs it on the CPU with ``--rcm``
    and float32 (the synthetic shard of scale 0.00002, RCM order,
    self-loops, GCN norms, hidden 32, 3 layers, lr 1e-2; off the TPU the
    JAX twin takes the flat XLA tier and the monolithic recipe): 3 losses
    at one part (S = D = 1) or on the two-level partition of an (S, D)
    grid."""
    from tests.test_torch_full_graph import _jax_example
    ei, x, y, train, _, c = _jax_example().synthetic_papers(0.00002)
    n = x.shape[0]
    perm, inv = jpar.reorder_bandwidth(ei, n)
    ei = inv[np.asarray(ei)]
    x, y, train = x[perm], y[perm], train[perm]
    ei = np.concatenate([ei, np.tile(np.arange(n), (2, 1))], 1)
    w = jnorm(ei, n)
    mask = train.astype(np.float32)
    if S * D == 1:
        mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
        jpart = jpar.build_halo_partition(ei, n, 1, w)
        ax = "dp"
    else:
        mesh = _hmesh(S, D)
        jpart = jpar.build_hier_halo_partition(ei, n, S, D, w)
        ax = ("slice", "dp")
    params, opt_state, step, _ = jpar.make_partitioned_gcn_train(
        mesh, jpart, x.shape[1], 32, c, num_layers=3,
        compute_dtype=jnp.float32, learning_rate=1e-2)
    xs, ys, ms = (jpar.shard_nodes(a, mesh, jpart, axis=ax)
                  for a in (x, y, mask))
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    return losses


def test_twin_with_rcm_on_one_part_matches_the_jax_recipe(capsys):
    from gammagl_tpu_torch.examples import papers100m_trainer as twin
    out = twin.main(twin.parser().parse_args(TWIN_ARGV + ["--slices", "1"]))
    assert out["tier"] == "planned" and out["rcm"] and out["parts"] == 1
    assert '"metric": "papers100m_gcn_epoch"' in capsys.readouterr().out
    np.testing.assert_allclose(out["losses"], _jax_twin(1, 1), rtol=1e-4)
    with pytest.raises(ValueError, match="--slices > 1 needs"):
        twin.main(twin.parser().parse_args(TWIN_ARGV + ["--slices", "2"]))


def test_twin_on_a_2x2_grid_matches_the_jax_recipe(four_parts):
    want = _jax_twin(2, 2)
    for r in range(4):
        np.testing.assert_array_equal(four_parts["twin:parts"][r], [4, 2])
        np.testing.assert_allclose(four_parts["twin:losses"][r], want,
                                   rtol=1e-4)
    assert want[-1] < want[0]


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cpu", 2, 8, "gloo"), ("cuda", 4, 1, "gloo"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl")])
def test_launcher_backend_follows_the_cards(device, local_world, cards,
                                            want):
    from gammagl_tpu_torch.examples import papers100m_trainer as twin
    assert twin.launcher_backend(device, local_world, cards) == want


def test_twin_joins_a_launcher_group(tmp_path):
    """The twin as ``torchrun`` starts it: two processes of ``python -m``
    with the launcher's environment join one gloo group (the CPU), train
    the (2, 1) grid and print the JSON line on rank 0 alone."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from tests.test_torch_halo_plan import REPO
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "gammagl_tpu_torch.examples.papers100m_trainer", *TWIN_ARGV,
             "--slices", "2"], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    assert "papers100m_gcn_epoch" not in logs[1]
    out = json.loads([ln for ln in logs[0].splitlines()
                      if "papers100m_gcn_epoch" in ln][-1])
    assert (out["parts"], out["slices"], out["tier"]) == (2, 2, "hier-planned")
    np.testing.assert_allclose(out["losses"], _jax_twin(1, 1), rtol=1e-4)


V5E_CASES = [dict(num_parts=8, edges_per_part=2_000_000,
                  halo_rows_sent=60_000, feat_dim=256),
             dict(num_parts=16, edges_per_part=500_000,
                  halo_rows_sent=400_000, feat_dim=128, itemsize=4,
                  dcn_rows_sent=90_000),
             dict(num_parts=4, edges_per_part=1_000_000,
                  halo_rows_sent=0, feat_dim=64, total_edges=3_100_000)]


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("case", range(len(V5E_CASES)))
def test_scaling_estimate_matches_jax_on_v5e_fields(case, overlap):
    kw = dict(V5E_CASES[case], overlap=overlap)
    want = jscaling.halo_scaling_estimate(hw=jscaling.V5E, **kw)
    got = tpar.halo_scaling_estimate(
        hw=tpar.HwModel(**jscaling.V5E._asdict()), **kw)
    assert got == want


def test_hw_model_defaults_are_the_cards():
    hw = tpar.HwModel()
    assert hw._fields == jscaling.HwModel._fields
    v5e = jscaling.V5E
    for field in hw._fields:
        assert getattr(hw, field) > 0
        assert getattr(hw, field) != getattr(v5e, field), field
    est = tpar.halo_scaling_estimate(4, 1_000_000, 10_000, 256)
    assert 0 < est["efficiency"] <= 1
