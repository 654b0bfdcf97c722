"""The port's SGFormer, GNN-LF/HF, CAGCN, MERIT, GRADE and `tadw`
(`models/wave3_models.py`) against the JAX package's.

Each model is built in JAX with its own ``init``, carried across with
`load_jax_params`, and fed the same numpy inputs (from a seed). Outputs
and the gradients of a loss of them in every parameter are held at 1e-5
of max |out| (of each parameter's max |grad|), float32; each JAX
reference is compiled once for the module (cached). Training-mode
forwards draw dropout masks in both packages; they are compared with
the rate at 0. `tadw` keeps JAX's numpy draws and runs its 20 steps in
torch: held at rtol 1e-4.
"""

import functools
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.models as jm  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

import gammagl_tpu_torch.models as tm  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

TOL = 1e-5
N, E, FEAT, HID, C = 30, 90, 12, 16, 4
KEY = jax.random.PRNGKey(5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are a few dozen rows wide: one torch thread for
    this module (the suite's workers share the host's cores), then the
    old count back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph(seed=0):
    """x (N, FEAT), edges with self-loops; nodes N-4.. have only their
    self-loops."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N - 4, E)])
    ei, _ = jax_add_self_loops(ei, num_nodes=N)
    return x, np.asarray(ei, np.int64)


X, EI = _graph()


def _t(a):
    return torch.from_numpy(np.array(a))


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _emb(shape):
    g = _cot(shape)
    return (lambda out: jnp.sum(out * g), lambda out: (out * _t(g)).sum())


IDENT = (lambda out: out, lambda out: out)


def _cases():
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    tx, tei = _t(X), _t(EI)
    rng = np.random.default_rng(5)
    x2 = (X * (rng.random((1, FEAT)) > 0.3)).astype(np.float32)
    w1 = (rng.random(EI.shape[1]) > 0.2).astype(np.float32)
    w2 = (rng.random(EI.shape[1]) > 0.4).astype(np.float32)
    w1[-N:] = w2[-N:] = 1.0  # every node keeps its self-loop
    ew = (rng.random(EI.shape[1]) * 0.8 + 0.2).astype(np.float32)
    two = (x, ei, jnp.asarray(w1), jnp.asarray(x2), ei, jnp.asarray(w2))
    ttwo = (tx, tei, _t(w1), _t(x2), tei, _t(w2))

    def merit_loss(j):
        byol = (jm.MERITModel.byol_loss if j else tm.MERITModel.byol_loss)
        return lambda out: 0.5 * (byol(out[0], out[1])
                                  + byol(out[1], out[0]))

    cases = {
        "sgformer": (jm.SGFormerModel(HID, C), (x, ei),
                     tm.SGFormerModel(HID, C), (tx, tei), *_emb((N, C))),
        "sgformer_2heads_3layers_weighted": (
            jm.SGFormerModel(HID, C, num_heads=2, gcn_layers=3,
                             graph_weight=0.6),
            (x, ei, jnp.asarray(ew)),
            tm.SGFormerModel(HID, C, num_heads=2, gcn_layers=3,
                             graph_weight=0.6), (tx, tei, _t(ew)),
            *_emb((N, C))),
        "gnnlf": (jm.GNNLFHFModel(HID, C, variant="lf", K=4), (x, ei),
                  tm.GNNLFHFModel(HID, C, variant="lf", K=4), (tx, tei),
                  *_emb((N, C))),
        "gnnhf": (jm.GNNLFHFModel(HID, C, variant="hf", K=5), (x, ei),
                  tm.GNNLFHFModel(HID, C, variant="hf", K=5), (tx, tei),
                  *_emb((N, C))),
        "gnnlf_weighted": (jm.GNNLFHFModel(HID, C, variant="lf", K=3,
                                           mu=0.3),
                           (x, ei, jnp.asarray(ew)),
                           tm.GNNLFHFModel(HID, C, variant="lf", K=3,
                                           mu=0.3), (tx, tei, _t(ew)),
                           *_emb((N, C))),
        "cagcn": (jm.CAGCNModel(C, hidden_dim=HID), (x, ei),
                  tm.CAGCNModel(C, hidden_dim=HID), (tx, tei),
                  *_emb((N, FEAT))),
        "merit": (jm.MERITModel(HID), two, tm.MERITModel(HID), ttwo,
                  lambda out: merit_loss(True)(out),
                  lambda out: merit_loss(False)(out)),
        "merit_views": (jm.MERITModel(HID), two, tm.MERITModel(HID), ttwo,
                        lambda out: jnp.sum(out[0] * _cot((N, HID), 1))
                        + jnp.sum(out[1] * _cot((N, HID), 2)),
                        lambda out: (out[0] * _t(_cot((N, HID), 1))).sum()
                        + (out[1] * _t(_cot((N, HID), 2))).sum()),
        "grade_loss": (jm.GRADEModel(HID), two, tm.GRADEModel(HID), ttwo,
                       *IDENT),
        "grade_embed": (jm.GRADEModel(HID), (x, ei, None),
                        tm.GRADEModel(HID), (tx, tei, None),
                        *_emb((N, HID))),
    }
    return cases


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The init tree: ``grade_embed`` takes ``grade_loss``'s (the head
    exists only in the loss form), ``merit_views`` ``merit``'s."""
    name = {"grade_embed": "grade_loss", "merit_views": "merit"}.get(name,
                                                                     name)
    jmod, jin = CASES[name][:2]
    return jax.jit(jmod.init)(KEY, *jin)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's output and the gradients of its loss, compiled once."""
    jmod, jin, _, _, jloss, _ = CASES[name]
    params = _jax_init(name)

    def loss(p):
        out = jmod.apply(p, *jin)
        return jloss(out), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_output_and_grads_match_jax(name):
    _, _, tmod, tin, _, tloss = CASES[name]
    params, want, grads = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    model.zero_grad(set_to_none=True)
    out = model(*tin)
    loss = tloss(out)
    loss.backward()
    for got_leaf, want_leaf in zip(_leaves(out), _leaves(want)):
        _check(got_leaf, want_leaf, TOL)
    _check_grads(model, grads, TOL)


def test_merit_loss_reaches_the_target_branch():
    """The twin's loss keeps the gradient through the target view, as
    JAX's ``jnp.asarray(z2)`` does (no stop-gradient): the second view's
    input gets a nonzero gradient from each half of the loss."""
    _, _, tmod, tin, _, tloss = CASES["merit"]
    model = load_jax_params(tmod, _jax_case("merit")[0])
    x2 = tin[3].clone().requires_grad_()
    z1, z2 = model(tin[0], tin[1], tin[2], x2, tin[4], tin[5])
    tm.MERITModel.byol_loss(z1, z2).backward()
    assert float(x2.grad.abs().max()) > 0


def test_training_mode_dropout_at_rate_zero_is_the_eval_forward():
    """SGFormer and GNN-LF/HF in training mode with their dropout at 0
    give the eval forward, so the twins compare at rate 0."""
    tx, tei = _t(X), _t(EI)
    for make in (lambda r: tm.SGFormerModel(HID, C, drop_rate=r,
                                            in_channels=FEAT),
                 lambda r: tm.GNNLFHFModel(HID, C, drop_rate=r,
                                           in_channels=FEAT)):
        torch.manual_seed(0)
        model = make(0.0)
        with torch.no_grad():
            a = model.train()(tx, tei)
            b = model.eval()(tx, tei)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gnnlfhf_product_counts():
    """The lf variant sums 2K products a forward, hf K."""
    from gammagl_tpu_torch.models import wave3_models
    calls = []
    real = wave3_models.spmm

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    wave3_models.spmm = counting
    try:
        for variant, want in (("lf", 2 * 6), ("hf", 6)):
            calls.clear()
            tm.GNNLFHFModel(HID, C, variant=variant, K=6,
                            in_channels=FEAT).eval()(_t(X), _t(EI))
            assert len(calls) == want
    finally:
        wave3_models.spmm = real


def _tadw_inputs(n=24, ft=9):
    rng = np.random.default_rng(11)
    adj = (rng.random((n, n)) < 0.2).astype(np.float32)
    adj[-1] = 0.0  # a node without edges
    return adj, rng.normal(size=(n, ft)).astype(np.float32)


@pytest.mark.parametrize("iters,lr", [(1, 0.01), (3, 0.01), (20, 1e-3)])
def test_tadw_matches_jax(iters, lr):
    """JAX's host numpy steps and the port's torch steps from the same
    draws, at step counts and rates where the steps stay finite (C38)."""
    adj, text = _tadw_inputs()
    want = jm.tadw(adj, text, dim=6, iters=iters, lr=lr, seed=3)
    got = tm.tadw(adj, text, dim=6, iters=iters, lr=lr, seed=3,
                  device="cpu")
    assert got.shape == (24, 12) and got.dtype == np.float32
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_tadw_diverges_at_its_defaults_in_both_packages():
    """ROADMAP C38 (follows): the plain gradient steps at the default
    rate 0.01 diverge (their step grows with N and the text's scale); at
    20 steps on the 80 dimensions of the tadw script JAX's embeddings are
    no longer finite, and the port's, from the same draws, neither."""
    adj, text = _tadw_inputs(60, 12)
    with np.errstate(all="ignore"):
        want = jm.tadw(adj, text, dim=80, seed=0)
    got = tm.tadw(adj, text, dim=80, seed=0, device="cpu")
    assert not np.isfinite(want).all() and not np.isfinite(got).all()


def test_models_own_init_runs_lazy():
    """The port's own init (lazy first maps): finite outputs and losses
    that backpropagate."""
    tx, tei = _t(X), _t(EI)
    w = torch.ones(EI.shape[1])
    for model, inputs in (
            (tm.SGFormerModel(HID, C), (tx, tei)),
            (tm.GNNLFHFModel(HID, C), (tx, tei)),
            (tm.CAGCNModel(C, HID), (tx, tei)),
            (tm.MERITModel(HID), (tx, tei, w, tx, tei, w)),
            (tm.GRADEModel(HID), (tx, tei, w, tx, tei, w))):
        out = model.train()(*inputs)
        loss = sum(o.sum() for o in _leaves(out))
        loss.backward()
        assert all(torch.isfinite(o).all() for o in _leaves(out))
