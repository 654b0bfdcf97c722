"""The port's segment reductions and COO SpMM against the JAX package.

Same numpy inputs to both. Out-of-range ids are dropped and empty
segments give 0 in both; f32 results agree to 1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gammagl_tpu import ops as jops
from gammagl_tpu_torch import ops


def _data(seed=0, n_rows=300, n_seg=40, F=6):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_rows, F)).astype(np.float32)
    # the padding id, ids past it and negative ids; segments 33..39 stay
    # empty
    ids = rng.integers(-3, 33, n_rows)
    ids[::17] = n_seg
    ids[::23] = n_seg + 7
    return data, ids, n_seg


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max", "segment_min"])
def test_segment_reductions_match_jax(name):
    data, ids, n = _data()
    got = getattr(ops, name)(torch.from_numpy(data), torch.from_numpy(ids), n)
    # JAX drops ids >= n; negative ids are dropped by the port, so give
    # JAX only the rows it drops the same way
    keep = ids >= 0
    want = getattr(jops, name)(jnp.asarray(data[keep]),
                               jnp.asarray(ids[keep]), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert bool((got[33:] == 0).all())


def test_segment_count_is_exact_in_float32():
    ids = torch.zeros(1000, dtype=torch.long)
    assert ops.segment_count(ids, 2).tolist() == [1000.0, 0.0]
    assert ops.segment_count(ids, 2, dtype=torch.bfloat16)[0] == 1000
    assert ops.segment_count(torch.tensor([0, 5, -1, 1]), 2).tolist() == \
        [1.0, 1.0]


def test_segment_checks_shapes():
    with pytest.raises(ValueError, match="1-D"):
        ops.segment_sum(torch.ones(3, 2), torch.zeros(3, 1), 2)
    with pytest.raises(ValueError, match="leading dim"):
        ops.segment_sum(torch.ones(3, 2), torch.zeros(4), 2)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("weighted", [False, True])
def test_coo_spmm_matches_jax(reduce, weighted):
    rng = np.random.default_rng(1)
    n, e = 60, 400
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 10, e)])
    w = rng.random(e).astype(np.float32) if weighted else None
    x = rng.normal(size=(n, 5)).astype(np.float32)
    got = ops.spmm(torch.from_numpy(ei), None if w is None else
                   torch.from_numpy(w), torch.from_numpy(x), reduce=reduce)
    want = jops.spmm(jnp.asarray(ei), None if w is None else jnp.asarray(w),
                     jnp.asarray(x), reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    alias = ops.gspmm(torch.from_numpy(ei), None if w is None else
                      torch.from_numpy(w), torch.from_numpy(x), reduce=reduce)
    assert torch.equal(alias, got)


def test_coo_spmm_rounds_once_to_input_dtype():
    ei = torch.tensor([[0, 1, 2], [1, 1, 1]])
    x = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -8]]).to(torch.bfloat16)
    out = ops.spmm(ei, None, x, num_nodes=2)
    # a bf16 running sum would lose each 2**-8 against 1.0
    assert out.dtype == torch.bfloat16
    assert out[1].item() == 1.0078125
    with pytest.raises(ValueError, match="unknown reduce"):
        ops.spmm(ei, None, x, reduce="prod")
