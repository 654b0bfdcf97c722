"""The port's segment reductions and COO SpMM against the JAX package.

Same numpy inputs to both. Out-of-range ids are dropped and empty
segments give 0 in both; f32 results agree to 1e-5. Integer inputs and
bf16 features with f32 weights give JAX's dtype (ROADMAP C12, C13):
integer sums, maxima and minima stay integer and agree exactly, an
integer mean is float32, and bf16 x with f32 weights is float32.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gammagl_tpu import ops as jops
from gammagl_tpu_torch import ops


def _data(seed=0, n_rows=300, n_seg=40, F=6, dtype="float32"):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_rows, F)).astype(np.float32)
    if dtype == "int32":
        data = rng.integers(-50, 50, (n_rows, F)).astype(np.int32)
    # the padding id, ids past it and negative ids; segments 33..39 stay
    # empty
    ids = rng.integers(-3, 33, n_rows)
    ids[::17] = n_seg
    ids[::23] = n_seg + 7
    return data, ids, n_seg


# ROADMAP C12's probe: int32 rows [1, 2 | 4, 7] into segments 0 and 1 of 3
PROBE_X = np.array([[1], [2], [4], [7]], np.int32)
PROBE_IDS = np.array([0, 0, 1, 1])
PROBE_W = np.array([0.5, 0.5, 0.25, 1.5], np.float32)


def _same_dtype(got, want):
    assert str(got.dtype) == f"torch.{np.asarray(want).dtype.name}", (
        got.dtype, np.asarray(want).dtype)


def _int_empty_extremes(reduce, got, want, ids, n):
    """JAX's result as numpy, with the empty segments of an integer max
    or min set to the port's 0 after checking both: the port gives 0 as
    for floats, JAX the dtype's identity of the reduction (ROADMAP quirk
    C9)."""
    want = np.array(want)
    if want.dtype.kind != "i" or reduce not in ("max", "min"):
        return want
    empty = np.bincount(ids[(ids >= 0) & (ids < n)], minlength=n) == 0
    info = np.iinfo(want.dtype)
    assert (want[empty] == (info.min if reduce == "max" else info.max)).all()
    assert bool((got[torch.from_numpy(empty)] == 0).all())
    want[empty] = 0
    return want


@pytest.mark.parametrize("case", ["float32", "int32", "probe"])
@pytest.mark.parametrize("name", ["segment_sum", "segment_mean",
                                  "segment_max", "segment_min"])
def test_segment_reductions_match_jax(name, case):
    if case == "probe":
        data, ids, n = PROBE_X, PROBE_IDS, 3
    else:
        data, ids, n = _data(dtype=case)
    got = getattr(ops, name)(torch.from_numpy(data), torch.from_numpy(ids), n)
    # JAX drops ids >= n; negative ids are dropped by the port, so give
    # JAX only the rows it drops the same way
    keep = ids >= 0
    want = getattr(jops, name)(jnp.asarray(data[keep]),
                               jnp.asarray(ids[keep]), n)
    _same_dtype(got, want)
    want = _int_empty_extremes(name[8:], got, want, ids[keep], n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if case == "probe" and name == "segment_mean":
        assert got.dtype == torch.float32
        assert got[:, 0].tolist() == [1.5, 5.5, 0.0]
    if case != "probe":
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


# the weighted probe's results (edges 0,1 -> 0 and 2,3 -> 1), float32
PROBE_SPMM = {"sum": [1.5, 11.5, 0.0], "mean": [0.75, 5.75, 0.0],
              "max": [1.0, 10.5, 0.0]}


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16", "probe"])
def test_coo_spmm_matches_jax(reduce, weighted, dtype):
    rng = np.random.default_rng(1)
    n, e = 60, 400
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 10, e)])
    w = rng.random(e).astype(np.float32) if weighted else None
    x = rng.normal(size=(n, 5)).astype(np.float32)
    if dtype == "int32":
        x = rng.integers(-20, 20, (n, 5)).astype(np.int32)
    if dtype == "probe":
        ei = np.stack([np.arange(4), PROBE_IDS])
        x, w = PROBE_X, PROBE_W if weighted else None
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    n = 3 if dtype == "probe" else n
    got = ops.spmm(torch.from_numpy(ei), None if w is None else
                   torch.from_numpy(w), tx, num_nodes=n, reduce=reduce)
    want = jops.spmm(jnp.asarray(ei), None if w is None else jnp.asarray(w),
                     jx, num_nodes=n, reduce=reduce)
    alias = ops.gspmm(torch.from_numpy(ei), None if w is None else
                      torch.from_numpy(w), tx, reduce=reduce, num_nodes=n)
    assert torch.equal(alias, got)
    if dtype == "bfloat16":
        # bf16 x f32 weights promote to float32 in both (C13)
        assert got.dtype == (torch.float32 if weighted else torch.bfloat16)
        assert want.dtype == (jnp.float32 if weighted else jnp.bfloat16)
        got, want = got.float(), np.asarray(want, np.float32)
    else:
        _same_dtype(got, want)
        want = _int_empty_extremes(reduce, got, want, ei[1], n)
    # JAX adds unweighted bf16 messages in bf16, the port in f32 and
    # rounds once: they differ by a few bf16 roundings of a row's sum
    tol = 3e-2 if dtype == "bfloat16" and not weighted else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    if dtype == "probe" and weighted and reduce in PROBE_SPMM:
        assert got.dtype == torch.float32
        assert got[:, 0].tolist() == PROBE_SPMM[reduce]


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_coo_bspmm_matches_jax(reduce, dtype):
    """Per-head f32 weights: the message dtype is JAX's (int32 or bf16 x
    with f32 weights: float32)."""
    rng = np.random.default_rng(2)
    n, e, H = 40, 300, 3
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 5, e)])
    w = rng.random((e, H)).astype(np.float32)
    x = (rng.integers(-20, 20, (n, H, 4)).astype(np.int32)
         if dtype == "int32" else rng.normal(size=(n, H, 4)).astype(np.float32))
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    got = ops.bspmm(torch.from_numpy(ei), torch.from_numpy(w), tx,
                    reduce=reduce)
    want = jops.bspmm(jnp.asarray(ei), jnp.asarray(w), jx, reduce=reduce)
    _same_dtype(got, want)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_coo_spmm_rounds_once_to_input_dtype():
    ei = torch.tensor([[0, 1, 2], [1, 1, 1]])
    x = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -8]]).to(torch.bfloat16)
    out = ops.spmm(ei, None, x, num_nodes=2)
    # a bf16 running sum would lose each 2**-8 against 1.0
    assert out.dtype == torch.bfloat16
    assert out[1].item() == 1.0078125
    with pytest.raises(ValueError, match="unknown reduce"):
        ops.spmm(ei, None, x, reduce="prod")


@pytest.mark.parametrize("layer", ["gcn", "gcn_weighted", "sage_gcn"])
def test_layers_keep_jax_dtype_in_bf16_on_coo(layer):
    """The layers that hand their own weights to the COO spmm (GCNConv's
    degree norms, SAGEConv's 'gcn' aggregator) round them to the JAX
    layer's dtype, so the output dtype is JAX's: bf16 without bias and
    caller weights, float32 with f32 caller weights. Values at bf16
    tolerance (3e-2 of max |out|)."""
    import jax
    from gammagl_tpu.layers.conv import GCNConv as JaxGCNConv
    from gammagl_tpu.layers.conv import SAGEConv as JaxSAGEConv
    from gammagl_tpu_torch.layers.conv import GCNConv, SAGEConv
    from gammagl_tpu_torch.utils import load_jax_params
    rng = np.random.default_rng(3)
    n, e, f_in = 50, 300, 8
    ei = rng.integers(0, n, (2, e))
    x = rng.normal(size=(n, f_in)).astype(np.float32)
    w = rng.random(e).astype(np.float32) if layer == "gcn_weighted" else None
    if layer.startswith("gcn"):
        jconv = JaxGCNConv(6, add_bias=False, dtype=jnp.bfloat16)
        conv = GCNConv(None, 6, add_bias=False, dtype=torch.bfloat16)
        jargs = () if w is None else (jnp.asarray(w),)
        targs = () if w is None else (torch.from_numpy(w),)
    else:
        jconv = JaxSAGEConv(6, aggr="gcn", add_bias=False,
                            dtype=jnp.bfloat16)
        conv = SAGEConv(None, 6, aggr="gcn", add_bias=False,
                        dtype=torch.bfloat16)
        jargs = targs = ()
    params = jconv.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(ei), *jargs)
    want = jconv.apply(params, jnp.asarray(x), jnp.asarray(ei), *jargs)
    conv = load_jax_params(conv, jax.tree_util.tree_map(np.asarray, params))
    got = conv(torch.from_numpy(x), torch.from_numpy(ei), *targs)
    _same_dtype(got, want)
    assert got.dtype == (torch.float32 if w is not None else torch.bfloat16)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=3e-2 * float(np.abs(want).max()))
