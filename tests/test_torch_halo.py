"""The port's halo partitioning and flat halo tier
(`gammagl_tpu_torch.parallel.halo`, `partition.balance_permutation`,
`utils.norm.calc_gcn_norm_np`) against the JAX package.

Host builders are held bit for bit. The flat tier runs at one part in
this process against `make_halo_spmm` on a one-device mesh: float32 at
1e-5 (both sum in f32 through XLA's or PyTorch's scatter), gradients
against `jax.grad` at 1e-5 of max |grad| (sums of both signs).
Multi-process runs of the tiers are in `test_torch_halo_plan.py`.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gammagl_tpu import parallel as jpar
from gammagl_tpu.utils import calc_gcn_norm_np as jax_gcn_norm_np

from gammagl_tpu_torch import parallel as tpar
from gammagl_tpu_torch.utils import calc_gcn_norm_np


def _powerlaw(n=300, e=4000, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (rng.zipf(1.5, e) - 1) % n  # skewed in-degree
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    return np.stack([src, dst]), w, x


@pytest.mark.parametrize("P_", [2, 4, 8])
def test_balance_permutation_bit_for_bit(P_):
    ei, _, _ = _powerlaw()
    want = jpar.balance_permutation(ei, 300, P_)
    got = tpar.balance_permutation(ei, 300, P_)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(got[0]), np.arange(300))


@pytest.mark.parametrize("P_,balance", [(1, True), (2, True), (4, True),
                                        (4, False)])
def test_build_halo_partition_fields_bit_for_bit(P_, balance):
    ei, w, _ = _powerlaw(seed=P_)
    want = jpar.build_halo_partition(ei, 300, P_, w, balance=balance)
    got = tpar.build_halo_partition(ei, 300, P_, w, balance=balance)
    assert got._fields == want._fields
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=field)
            assert np.asarray(a).dtype == np.asarray(b).dtype, field
    assert got.halo_total == want.halo_total


@pytest.mark.parametrize("weighted", [False, True])
def test_calc_gcn_norm_np_bit_for_bit(weighted):
    ei, w, _ = _powerlaw(seed=3)
    ei = np.concatenate([ei, np.tile(np.arange(300), (2, 1))], 1)
    ew = np.abs(np.concatenate([w, np.ones(300, np.float32)])) if weighted \
        else None
    got = calc_gcn_norm_np(ei, 310, ew)  # 10 nodes without edges
    want = jax_gcn_norm_np(ei, 310, ew)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]), ("dp",))


def test_flat_tier_one_part_matches_jax():
    ei, w, x = _powerlaw(seed=5)
    part = tpar.build_halo_partition(ei, 300, 1, w)
    jpart = jpar.build_halo_partition(ei, 300, 1, w)
    mesh = _mesh1()
    xs = jax.device_put(jnp.asarray(jpar.pad_nodes(x, jpart)),
                        NamedSharding(mesh, P("dp")))
    spmm_j = jpar.make_halo_spmm(mesh, jpart)
    want = np.asarray(jax.jit(spmm_j)(xs))
    grad_j = np.asarray(jax.jit(jax.grad(
        lambda v: jnp.sum(spmm_j(v) ** 2)))(xs))
    xt = tpar.shard_nodes(x, part, device="cpu").requires_grad_()
    out = tpar.make_halo_spmm(part)(xt)
    assert out.shape == (part.rows_per, 12) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), grad_j, rtol=1e-5,
                               atol=1e-5 * np.abs(grad_j).max())
    # dense check of the function
    a = np.zeros((300, 300))
    np.add.at(a, (ei[1], ei[0]), w)
    np.testing.assert_allclose(tpar.unpad_nodes(out, part), a @ x,
                               rtol=1e-4, atol=1e-4)


def test_flat_tier_bf16_sums_in_f32_like_jax():
    ei, w, x = _powerlaw(seed=6)
    part = tpar.build_halo_partition(ei, 300, 1, w)
    jpart = jpar.build_halo_partition(ei, 300, 1, w)
    mesh = _mesh1()
    xs = jax.device_put(jnp.asarray(jpar.pad_nodes(x, jpart), jnp.bfloat16),
                        NamedSharding(mesh, P("dp")))
    want = jax.jit(jpar.make_halo_spmm(mesh, jpart))(xs)
    got = tpar.make_halo_spmm(part)(tpar.shard_nodes(
        x, part, device="cpu", dtype=torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pad_unpad_round_trip_with_balanced_relabeling():
    ei, w, x = _powerlaw(seed=7)
    part = tpar.build_halo_partition(ei, 300, 4, w)
    jpart = jpar.build_halo_partition(ei, 300, 4, w)
    assert part.node_perm is not None
    padded = tpar.pad_nodes(x, part)
    np.testing.assert_array_equal(padded, jpar.pad_nodes(x, jpart))
    np.testing.assert_array_equal(tpar.unpad_nodes(padded, part), x)
    np.testing.assert_array_equal(
        tpar.unpad_nodes(torch.from_numpy(padded), part), x)
    blocks = [tpar.shard_nodes(x, part, rank=r, device="cpu",
                               dtype=torch.float64) for r in range(4)]
    assert all(b.shape == (part.rows_per, 12) for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), padded)


def test_parts_need_a_group_of_their_size():
    ei, w, _ = _powerlaw(seed=8)
    assert tpar.part_world(1) == (0, 1, None)
    assert tpar.world() == (0, 1, None)
    with pytest.raises(RuntimeError, match="4 parts"):
        tpar.make_halo_spmm(tpar.build_halo_partition(ei, 300, 4, w))
    with pytest.raises(RuntimeError, match="not initialised"):
        tpar.world(group=object())


def test_shard_nodes_asks_for_the_card_by_default(monkeypatch):
    ei, w, x = _powerlaw(seed=9)
    part = tpar.build_halo_partition(ei, 300, 1, w)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.shard_nodes(x, part)
