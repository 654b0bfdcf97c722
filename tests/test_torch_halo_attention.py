"""The port's partitioned GAT (`gammagl_tpu_torch.parallel.halo_attention`
and `make_partitioned_gat_train`) against the JAX package.

* The partition: ``send_idx``, ``rows_per``, ``halo_per_peer``, R, ET bit
  for bit at 1, 2 and 3 parts; each part's plan holding the JAX plan's
  edges (``(src, dst)`` pairs of its real lanes, as sets: the JAX plans are
  tiled for the TPU); ``send_count`` the real rows of each send list.
* The layer at one part in this process and at two gloo processes (CPU),
  heads 1 and 4: float32 output and the gradients in ``h``, ``a_src`` and
  ``a_dst`` of sum(out**2) against the JAX layer, whose per-head
  aggregation is the Pallas segment-matmul in interpret mode (bf16x3
  products: 1e-4 of max |.|); bf16 against a float32 run of the same
  (rounded) inputs at rtol 2e-2 and against the JAX bf16 layer at 3e-2 of
  max |.|. A destination without edges gives 0.
* `make_partitioned_gat_train` at one part and at two processes: the
  initial parameters bit for bit, 3 losses against JAX's recipe (1e-4)
  and the step-0 gradients against ``jax.grad`` of the recipe's forward
  and loss (1e-4). The workers import no JAX.
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
from gammagl_tpu.parallel import full_graph as jfg

from gammagl_tpu_torch import parallel as tpar

from tests.test_torch_halo_plan import _run_parts

N, E_, FH = 120, 900, 6


def _graph(seed=0, n=N, e=E_):
    """Random edges; the last 7 rows have none coming in."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e), rng.integers(0, n - 7, e)])


def _inputs(heads, seed=1, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, heads * FH)).astype(np.float32),
            rng.normal(size=(heads, FH)).astype(np.float32),
            rng.normal(size=(heads, FH)).astype(np.float32))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _jax_edges(part, p):
    valid = part.valid[p] > 0
    return _pairs(part.src_pad[p][valid], part.row_global[p][valid])


def _port_edges(plan):
    rows = np.repeat(np.arange(plan.num_nodes), np.diff(plan.rowptr))
    return _pairs(plan.col, rows)


def _pairs(src, dst):
    pairs = np.stack([np.asarray(src, np.int64), np.asarray(dst, np.int64)])
    return pairs[:, np.lexsort(pairs[::-1])]


@pytest.mark.parametrize("P_", [1, 2, 3])
def test_partition_matches_jax(P_):
    ei = _graph()
    want = jpar.build_halo_partition_attn(ei, N, P_, R=16, ET=128)
    got = tpar.build_halo_partition_attn(ei, N, P_, R=16, ET=128)
    np.testing.assert_array_equal(got.send_idx, want.send_idx)
    assert got.send_idx.dtype == want.send_idx.dtype
    for field in ("num_parts", "rows_per", "halo_per_peer", "num_nodes"):
        assert getattr(got, field) == getattr(want, field), field
    rows, H = got.rows_per, got.halo_per_peer
    for p in range(P_):
        np.testing.assert_array_equal(_port_edges(got.plans[p]),
                                      _jax_edges(want, p))
        assert got.plans[p].num_src == rows + (P_ * H if P_ > 1 else 0)
        # send_count[q, p]: the sources part p takes from q
        owner = np.minimum(ei[0] // rows, P_ - 1)
        mine = np.minimum(ei[1] // rows, P_ - 1) == p
        for q in range(P_):
            need = 0 if q == p else np.unique(ei[0][mine & (owner == q)]).size
            assert got.send_count[q, p] == need


def _mesh(P_):
    return Mesh(np.asarray(jax.devices()[:P_]), ("dp",))


@functools.lru_cache(maxsize=None)
def _jax_layer(P_, heads, dtype):
    """The JAX layer's output and the gradients of sum(out**2) in h,
    a_src and a_dst; padded rows, float32 numpy."""
    ei = _graph()
    h, a_s, a_d = _inputs(heads)
    part = jpar.build_halo_partition_attn(ei, N, P_, R=16, ET=128)
    mesh = _mesh(P_)
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    hs = jax.device_put(jnp.asarray(jpar.pad_nodes(h, part), jd),
                        NamedSharding(mesh, P("dp")))
    layer = jpar.make_partitioned_gat_layer(mesh, part, heads)

    def loss(v, s, d):
        out = layer(v, s, d)
        return jnp.sum(out.astype(jnp.float32) ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(hs, a_s, a_d)
    return tuple(np.asarray(a.astype(jnp.float32))
                 for a in (out,) + tuple(grads))


def _port_layer(part, heads, dtype, h, a_s, a_d, rank=0):
    """The port layer on ``rank``'s block: output and the gradients of
    sum(out**2), float32 numpy."""
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    hb = tpar.shard_nodes(h, part, rank=rank, device="cpu",
                          dtype=td).requires_grad_()
    st = torch.from_numpy(a_s).requires_grad_()
    dt = torch.from_numpy(a_d).requires_grad_()
    out = tpar.make_partitioned_gat_layer(part, heads)(hb, st, dt)
    assert out.dtype == td and out.shape == (part.rows_per, h.shape[1])
    (out.float() ** 2).sum().backward()
    return (out.detach().float().numpy(), hb.grad.float().numpy(),
            st.grad.numpy(), dt.grad.numpy())


def _check_layer(got, P_, heads, dtype):
    """``got``: (out, dh, da_src, da_dst), padded rows in part order."""
    want = _jax_layer(P_, heads, dtype)
    if dtype == "f32":
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-4 * np.abs(b).max())
        return
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-2 * np.abs(b).max())
    # an f32 run of the same rounded inputs
    ei = _graph()
    h, a_s, a_d = _inputs(heads)
    ref = _port_layer(tpar.build_halo_partition_attn(ei, N, 1, R=16, ET=128),
                      heads, "f32", _bf16(h), a_s, a_d)
    part = tpar.build_halo_partition_attn(ei, N, P_, R=16, ET=128)
    for a, b in zip(got[:2], ref[:2]):
        b = tpar.pad_nodes(b[:N], part)
        np.testing.assert_allclose(a, b, rtol=2e-2,
                                   atol=2e-2 * np.abs(b).max())
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a, b, rtol=2e-2,
                                   atol=2e-2 * np.abs(b).max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 4])
def test_layer_at_one_part_matches_jax(heads, dtype):
    part = tpar.build_halo_partition_attn(_graph(), N, 1, R=16, ET=128)
    got = _port_layer(part, heads, dtype, *_inputs(heads))
    _check_layer(got, 1, heads, dtype)
    # the last 7 rows have no edges: 0, as the JAX layer's
    np.testing.assert_array_equal(got[0][N - 7:N], 0)


def test_layer_rules():
    part = tpar.build_halo_partition_attn(_graph(), N, 1)
    layer = tpar.make_partitioned_gat_layer(part, 4)
    h, a_s, a_d = _inputs(4)
    with pytest.raises(ValueError, match="block"):
        layer(torch.from_numpy(h[:10]), torch.from_numpy(a_s),
              torch.from_numpy(a_d))
    with pytest.raises(ValueError, match="block"):
        tpar.make_partitioned_gat_layer(part, 5)(
            torch.from_numpy(h), torch.from_numpy(a_s),
            torch.from_numpy(a_d))
    two = tpar.build_halo_partition_attn(_graph(), N, 2)
    with pytest.raises(RuntimeError, match="world size 2"):
        tpar.make_partitioned_gat_layer(two, 4)
    with pytest.raises(TypeError, match="AttnHaloPartition"):
        tpar.make_partitioned_gat_train(
            tpar.build_halo_partition(_graph(), N, 1), 24, 8, 3,
            device="cpu")


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
n = int(d["n"])
part = tpar.build_halo_partition_attn(d["ei"], n, P_, R=16, ET=128)
res = {}
for heads in (1, 4):
    for dt in ("f32", "bf16"):
        hb = tpar.shard_nodes(d[f"h{heads}"], part, device="cpu",
                              dtype=DT[dt]).requires_grad_()
        st = torch.from_numpy(d[f"as{heads}"]).requires_grad_()
        at = torch.from_numpy(d[f"ad{heads}"]).requires_grad_()
        out = tpar.make_partitioned_gat_layer(part, heads)(hb, st, at)
        (out.float() ** 2).sum().backward()
        key = f"{heads}:{dt}"
        res[key + ":out"] = out.detach().float().numpy()
        res[key + ":dh"] = hb.grad.float().numpy()
        res[key + ":das"] = st.grad.numpy()
        res[key + ":dad"] = at.grad.numpy()
gp = tpar.build_halo_partition_attn(d["gei"], d["gx"].shape[0], P_, R=16,
                                    ET=128)
params, opt, step, ev = tpar.make_partitioned_gat_train(
    gp, d["gx"].shape[1], 8, int(d["gc"]), heads=4, num_layers=2,
    compute_dtype=torch.float32, learning_rate=5e-2, device="cpu")
xs, ys, ms = (tpar.shard_nodes(d[k], gp, device="cpu")
              for k in ("gx", "gy", "gmask"))
_, grads = step.loss_and_grads(params, xs, ys, ms)
for k_, v in grads.items():
    res["gat:grad:" + k_] = v.numpy()
losses = []
for _ in range(3):
    params, opt, loss = step(params, opt, xs, ys, ms)
    losses.append(float(loss))
res["gat:losses"] = np.asarray(losses)
dist.barrier()
dist.destroy_process_group()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "gammagl_tpu" or m.startswith("gammagl_tpu.")]
assert not bad, bad
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


def _gat_graph():
    from tests.test_torch_full_graph import _graph as gcn_graph
    ei, _, x, y, mask, c = gcn_graph(seed=6, n=120, e=800)
    return ei, x, y, mask, c


@pytest.fixture(scope="module")
def two_parts(tmp_path_factory):
    arrays = {}
    for heads in (1, 4):
        arrays[f"h{heads}"], arrays[f"as{heads}"], arrays[f"ad{heads}"] = \
            _inputs(heads)
    gei, gx, gy, gmask, gc = _gat_graph()
    parts = _run_parts(tmp_path_factory.mktemp("gat2"), 2, worker=WORKER,
                       ei=_graph(), n=N, gei=gei, gx=gx, gy=gy,
                       gmask=gmask, gc=gc, **arrays)
    out = {}
    for key in parts[0]:
        if key.endswith((":out", ":dh")):
            out[key] = np.concatenate([p[key] for p in parts])
        elif key.endswith((":das", ":dad")):
            out[key] = sum(p[key] for p in parts)  # a's share of each part
        else:
            out[key] = [p[key] for p in parts]
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [1, 4])
def test_layer_at_two_parts_matches_jax(two_parts, heads, dtype):
    key = f"{heads}:{dtype}"
    got = tuple(two_parts[f"{key}:{k}"] for k in ("out", "dh", "das", "dad"))
    _check_layer(got, 2, heads, dtype)


@functools.lru_cache(maxsize=None)
def _jax_gat(P_):
    """JAX's GAT recipe at P_ parts (heads 4 x 8, 2 layers, f32): its
    initial parameters, the step-0 gradients (`jax.grad` of the recipe's
    forward and loss) and 3 losses."""
    ei, x, y, mask, c = _gat_graph()
    n = x.shape[0]
    mesh = _mesh(P_)
    part = jpar.build_halo_partition_attn(ei, n, P_, R=16, ET=128)
    params, opt_state, step, _ = jfg.make_partitioned_gat_train(
        mesh, part, x.shape[1], 8, c, heads=4, num_layers=2,
        compute_dtype=jnp.float32, learning_rate=5e-2)
    init = {k: np.asarray(v) for k, v in params.items()}
    xs, ys, ms = (jpar.shard_nodes(a, mesh, part) for a in (x, y, mask))
    attn = jpar.make_partitioned_gat_layer(mesh, part, 4)

    def loss_fn(p):
        h = xs
        for i in range(2):
            h = attn(h @ p[f"w{i}"], p[f"as{i}"], p[f"ad{i}"])
            if i == 0:
                h = jax.nn.elu(h + p[f"b{i}"])
            else:
                h = h.reshape(h.shape[0], 4, -1).mean(axis=1) + p[f"b{i}"]
        ls = optax.softmax_cross_entropy_with_integer_labels(h, ys)
        return (ls * ms).sum() / jnp.maximum(ms.sum(), 1.0)

    grads = {k: np.asarray(v) for k, v in jax.jit(jax.grad(loss_fn))(
        params).items()}
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    return init, grads, losses


def _check_gat(init, grads, losses, P_):
    j_init, j_grads, j_losses = _jax_gat(P_)
    for k, want in j_init.items():
        np.testing.assert_array_equal(init[k], want, err_msg=k)
    for k, want in j_grads.items():
        np.testing.assert_allclose(grads[k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_gat_recipe_at_one_part_matches_jax():
    ei, x, y, mask, c = _gat_graph()
    part = tpar.build_halo_partition_attn(ei, x.shape[0], 1, R=16, ET=128)
    params, opt, step, ev = tpar.make_partitioned_gat_train(
        part, x.shape[1], 8, c, heads=4, num_layers=2,
        compute_dtype=torch.float32, learning_rate=5e-2, device="cpu")
    assert list(params) == ["w0", "as0", "ad0", "b0", "w1", "as1", "ad1",
                            "b1"]
    init = {k: v.detach().numpy().copy() for k, v in params.items()}
    xs, ys, ms = (tpar.shard_nodes(a, part, device="cpu")
                  for a in (x, y, mask))
    _, grads = step.loss_and_grads(params, xs, ys, ms)
    losses = []
    for _ in range(3):
        params, opt, loss = step(params, opt, xs, ys, ms)
        losses.append(float(loss))
    _check_gat(init, {k: v.numpy() for k, v in grads.items()}, losses, 1)
    logits = ev(params, xs)
    assert logits.dtype == torch.float32
    assert logits.shape == (part.rows_per, c)


def test_gat_recipe_at_two_parts_matches_jax(two_parts):
    init = _jax_gat(2)[0]  # the init is held at one part
    grads = {k.split(":")[-1]: v[0] for k, v in two_parts.items()
             if k.startswith("gat:grad:")}
    for k in grads:  # every part holds the summed gradients
        np.testing.assert_array_equal(two_parts["gat:grad:" + k][1],
                                      grads[k])
    for p in two_parts["gat:losses"]:
        _check_gat(init, grads, list(p), 2)


def test_remat_and_bf16_recipe_run():
    ei, x, y, mask, c = _gat_graph()
    part = tpar.build_halo_partition_attn(ei, x.shape[0], 1)
    out = {}
    for remat in (True, False):
        params, opt, step, _ = tpar.make_partitioned_gat_train(
            part, x.shape[1], 8, c, heads=2, num_layers=3, remat=remat,
            compute_dtype=torch.float32, device="cpu")
        xs, ys, ms = (tpar.shard_nodes(a, part, device="cpu")
                      for a in (x, y, mask))
        out[remat] = step.loss_and_grads(params, xs, ys, ms)
    assert torch.equal(out[True][0], out[False][0])
    for k in out[True][1]:
        torch.testing.assert_close(out[True][1][k], out[False][1][k],
                                   rtol=0, atol=0)
    params, opt, step, ev = tpar.make_partitioned_gat_train(
        part, x.shape[1], 8, c, heads=2, device="cpu")
    xs = tpar.shard_nodes(x, part, device="cpu", dtype=torch.bfloat16)
    ys, ms = (tpar.shard_nodes(a, part, device="cpu") for a in (y, mask))
    losses = [float(step(params, opt, xs, ys, ms)[2]) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
