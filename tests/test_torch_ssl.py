"""The port's self-supervised, autoencoder and spectral models
(`models/ssl.py`, `models/autoencoder.py`, `models/spectral.py`) against
the JAX package's.

Each model is built in JAX with its own ``init``, carried across with
`load_jax_params`, and fed the same numpy inputs (from a seed), with
JAX's draws (the corruption permutation, the view masks, VGAE's noise)
handed to the port as arguments. Outputs and the gradients of a loss of
them in every parameter are held at 1e-5 of max |out| (of each
parameter's max |grad|), float32; the augmentations and
`laplacian_eigh` bitwise. Each JAX reference is compiled once for the
module (`_jax_case`, cached) and read by the cases that need it.
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
from gammagl_tpu.models.spectral import _EigEncoding  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

import gammagl_tpu_torch.models as tm  # noqa: E402
from gammagl_tpu_torch.models.spectral import _eig_encoding  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are a few dozen rows wide: torch's intra-op threads
    only add fork-and-join cost, which grows without bound when the
    suite's workers share the host's cores. One thread for this module,
    then the old count back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
N, E, FEAT, HID = 30, 90, 12, 16


def _graph(seed=0):
    """x (N, FEAT), edges with self-loops (the trainers' graph), a fixed
    cotangent seed."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N - 4, E)])
    ei, _ = jax_add_self_loops(ei, num_nodes=N)
    return x, np.asarray(ei, np.int64)


X, EI = _graph()
KEY = jax.random.PRNGKey(3)


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dtype) if dtype else \
        torch.from_numpy(np.array(a))


def _views(key, de, df):
    """JAX's draws of `drop_edge_and_feature(key, x, ei, feat_drop=de,
    edge_drop=df)`: (feature mask, edge mask)."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.bernoulli(k1, 1 - de, (1, FEAT))),
            np.array(jax.random.bernoulli(k2, 1 - df, (EI.shape[1],))))


def _tu_batch(seed=1, graphs=4, n=7):
    rng = np.random.default_rng(seed)
    xs, eis, batch, off = [], [], [], 0
    for g in range(graphs):
        a = rng.random((n, n)) < 0.3
        eis.append(np.stack(np.nonzero(a)) + off)
        xs.append(rng.normal(size=(n, 5)).astype(np.float32))
        batch += [g] * n
        off += n
    return (np.concatenate(xs), np.concatenate(eis, 1).astype(np.int64),
            np.asarray(batch, np.int64), graphs)


def _sum_with(g):
    """A loss of an output: sum(out * g) for a fixed g from the seed."""
    return lambda out: jnp.sum(out * g)


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _cases():
    """name -> (jax model, jax inputs, port model, port inputs, loss of
    the output in JAX, the same in torch). The ``*_loss`` cases' outputs
    are the models' own losses."""
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    tx, tei = _t(X), _t(EI)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(5), N))
    xc = X[perm]
    fm1, em1 = _views(jax.random.PRNGKey(6), 0.2, 0.3)
    fm2, em2 = _views(jax.random.PRNGKey(7), 0.4, 0.1)
    # every node keeps its self-loop (the last N edges), so no row of a
    # view is exactly 0: there JAX's gradient is NaN (ROADMAP C28,
    # `test_grace_zero_row_gradient_is_finite` on the drawn masks)
    em1[-N:] = em2[-N:] = True
    x1, w1 = X * fm1, em1.astype(np.float32)
    x2, w2 = X * fm2, em2.astype(np.float32)
    diff_w = np.asarray(jax.random.uniform(jax.random.PRNGKey(8),
                                           (EI.shape[1],)))
    tb = _tu_batch()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (N, 8)))
    neg = np.stack([np.arange(N), (np.arange(N) * 7 + 3) % N])
    from gammagl_tpu_torch.models.spectral import laplacian_eigh
    lam, u = laplacian_eigh(EI, N)
    ident = (lambda out: out, lambda out: out)

    def emb(shape=(N, HID)):
        g = _cot(shape)
        return (_sum_with(g), lambda out: (out * _t(g)).sum())

    def vgae_loss(mod, arr):
        def f(out):
            mu, logstd, z = out
            return (mod.recon_loss(z, arr(EI), arr(neg))
                    + (1.0 / N) * mod.VGAEModel.kl_loss(mu, logstd))
        return f

    def info_loss(g):
        return (lambda out: out[0] + jnp.sum(out[1] * g),
                lambda out: out[0] + (out[1] * _t(g)).sum())

    return {
        "dgi_loss": (jm.DGIModel(HID), (x, ei, xc), tm.DGIModel(HID),
                     (tx, tei, _t(xc)), *ident),
        "dgi_embed": (jm.DGIModel(HID), (x, ei), tm.DGIModel(HID),
                      (tx, tei), *emb()),
        "grace_loss": (jm.GraceModel(HID, HID), (x1, ei, w1, x2, ei, w2),
                       tm.GraceModel(HID, HID),
                       (_t(x1), tei, _t(w1), _t(x2), tei, _t(w2)), *ident),
        "grace_embed": (jm.GraceModel(HID, HID), (x, ei, None),
                        tm.GraceModel(HID, HID), (tx, tei, None), *emb()),
        "mvgrl_loss": (jm.MVGRLModel(HID), (x, ei, ei, diff_w, xc),
                       tm.MVGRLModel(HID),
                       (tx, tei, tei, _t(diff_w), _t(xc)), *ident),
        "mvgrl_embed": (jm.MVGRLModel(HID), (x, ei, ei, diff_w),
                        tm.MVGRLModel(HID), (tx, tei, tei, _t(diff_w)),
                        *emb()),
        "infograph": (jm.InfoGraph(HID, 2), (tb[0], tb[1], tb[2], tb[3]),
                      tm.InfoGraph(HID, 2),
                      (_t(tb[0]), _t(tb[1]), _t(tb[2]), tb[3]),
                      *info_loss(_cot((tb[3], 2 * HID)))),
        "ggd_loss": (jm.GGDModel(HID), (x, ei, xc), tm.GGDModel(HID),
                     (tx, tei, _t(xc)), *ident),
        "ggd_embed": (jm.GGDModel(HID), (x, ei), tm.GGDModel(HID),
                      (tx, tei), *emb()),
        "gae": (jm.GAEModel(HID, 8), (x, ei), tm.GAEModel(HID, 8),
                (tx, tei), *emb((N, 8))),
        "vgae_loss": (jm.VGAEModel(HID, 8), (x, ei), tm.VGAEModel(HID, 8),
                      (tx, tei), vgae_loss(jm, jnp.asarray),
                      vgae_loss(tm, _t)),
        "specformer": (jm.SpecformerModel(3, HID, num_filters=2,
                                          drop_rate=0),
                       (x, jnp.asarray(lam), jnp.asarray(u)),
                       tm.SpecformerModel(3, HID, num_filters=2, drop_rate=0),
                       (tx, _t(lam), _t(u)), *emb((N, 3))),
        "mgnni": (jm.MGNNIModel(3, HID, scales=(1, 2), iters=8), (x, ei),
                  tm.MGNNIModel(3, HID, scales=(1, 2), iters=8), (tx, tei),
                  *emb((N, 3))),
    }, noise


CASES, NOISE = _cases()


def _distinct_singular(params):
    """MGNNI's tree with each ``w_m`` times diag(0.6 ... 1.4): singular
    values apart. At the orthogonal init all are 1, and the gradient of
    the spectral norm there is any mix of the u_i v_i^T; each package
    picks by rounding (ROADMAP C29, `test_mgnni_at_the_orthogonal_init`)."""
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    for key in tree:
        if key.startswith("w_"):
            tree[key] = tree[key] * np.linspace(
                0.6, 1.4, tree[key].shape[1], dtype=np.float32)
    return {"params": tree}


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX model's init tree, jitted: an ``*_embed`` case takes its
    ``*_loss`` case's (the discriminator exists only in the loss form)."""
    name = name.replace("_embed", "_loss")
    jmod, jin = CASES[name][:2]
    static = (4,) if name == "infograph" else ()  # num_graphs
    return jax.jit(jmod.init, static_argnums=static)(
        {"params": KEY, "dropout": KEY} if name == "specformer" else KEY,
        *jin)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name):
    """params -> (the case's output, the gradients of its loss), compiled
    once for the module."""
    jmod, jin, _, _, jloss, _ = CASES[name]
    if name == "vgae_loss":
        def f(p):  # the noise as an argument, not a draw in the trace
            mu, logstd = jmod.apply(p, *jin)[:2]
            return mu, logstd, mu + jnp.exp(logstd) * NOISE
    else:
        def f(p):
            return jmod.apply(p, *jin)

    def loss(p):
        out = f(p)
        return jloss(out), out

    return jax.jit(jax.grad(loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's init tree (MGNNI's with its singular values apart), its
    output and the gradients of its loss."""
    params = _jax_init(name)
    if name == "mgnni":
        params = _distinct_singular(params)
    grads, out = _jax_value_and_grad(name)(params)
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


def _port(name):
    _, _, tmod, tin, _, tloss = CASES[name]
    params, _, _ = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    model.zero_grad(set_to_none=True)
    if name == "vgae_loss":
        out = model(*tin, noise=_t(NOISE))
    else:
        out = model(*tin)
    tloss(out).backward()
    return model, out


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_output_and_grads_match_jax(name):
    model, out = _port(name)
    _, want, grads = _jax_case(name)
    for got_leaf, want_leaf in zip(_leaves(out), _leaves(want)):
        _check(got_leaf, want_leaf, TOL)
    # softmax ignores a constant added to every score of a row: the key
    # bias's gradient is 0 by the math (both sides hold rounding noise)
    _check_grads(model, grads, TOL, zero=("SelfAttention_0/key/bias",))


def test_mgnni_at_the_orthogonal_init():
    """ROADMAP C29. At MGNNI's init each ``w_m`` is orthogonal: its
    singular values all round to 1, so the spectral norm's gradient there
    has no one value. The output and every gradient but the ``w_m``'s
    still match JAX's; the ``w_m``'s are held at distinct singular
    values (the case ``mgnni``)."""
    _, _, _, tin, _, tloss = CASES["mgnni"]
    params = _jax_init("mgnni")
    w = np.asarray(params["params"]["w_1"])
    np.testing.assert_allclose(np.linalg.svd(w, compute_uv=False), 1.0,
                               atol=1e-5)
    grads, out = _jax_value_and_grad("mgnni")(params)
    model = load_jax_params(tm.MGNNIModel(3, HID, scales=(1, 2), iters=8),
                            _np_tree(params))
    got = model(*tin)
    tloss(got).backward()
    _check(got, out, TOL)
    for name, lin in (("Dense_0", model.fx), ("Dense_1", model.head)):
        _check(lin.weight.grad.T, grads["params"][name]["kernel"], TOL)
        _check(lin.bias.grad, grads["params"][name]["bias"], TOL)


def test_vgae_without_noise_returns_mu_twice():
    model, _ = _port("vgae_loss")
    with torch.no_grad():
        mu, logstd, z = model(_t(X), _t(EI))
    assert torch.equal(mu, z)
    assert float(logstd.abs().max()) <= 10


def test_corrupt_features_with_jax_perm_is_bitwise():
    key = jax.random.PRNGKey(11)
    want = np.asarray(jm.corrupt_features(key, jnp.asarray(X)))
    perm = _t(np.asarray(jax.random.permutation(key, N)))
    np.testing.assert_array_equal(tm.corrupt_features(_t(X), perm=perm)
                                  .numpy(), want)


@pytest.mark.parametrize("rates", [(0.2, 0.2), (0.4, 0.1)])
def test_drop_edge_and_feature_with_jax_masks_is_bitwise(rates):
    key = jax.random.PRNGKey(12)
    fd, ed = rates
    jx, jw = jm.drop_edge_and_feature(key, jnp.asarray(X), jnp.asarray(EI),
                                      fd, ed)
    fmask, emask = _views(key, fd, ed)
    tx, tw = tm.drop_edge_and_feature(_t(X), _t(EI), fd, ed,
                                      feat_mask=_t(fmask),
                                      edge_mask=_t(emask))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_port_draws_follow_the_generator():
    """The port's own draws: one generator state gives one draw; a
    permutation; masks of the right shapes and rates."""
    x = torch.arange(4000.0).reshape(2000, 2)
    ei = torch.zeros(2, 20000, dtype=torch.long)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return (tm.corrupt_features(x, g),
                *tm.drop_edge_and_feature(x.repeat(1, 500) + 1, ei, 0.3,
                                         0.6, g))
    a, b = draw(0), draw(0)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert torch.equal(a[0][:, 0].sort().values, x[:, 0])
    assert not torch.equal(a[0], x)
    kept_cols = float((a[1][0] != 0).float().mean())
    assert a[2].shape == (20000,) and abs(float(a[2].mean()) - 0.4) < 0.02
    assert abs(kept_cols - 0.7) < 0.05


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(4)
    z1, z2 = (rng.normal(size=(N, 6)).astype(np.float32) for _ in range(2))
    neg = np.stack([rng.integers(0, N, 40), rng.integers(0, N, 40)])
    want = jax.jit(lambda a, b, e, n: (
        jm.grace_loss(a, b, 0.7), jm.inner_product_decoder(a, e, True),
        jm.inner_product_decoder(a, e, False), jm.recon_loss(a, e, n),
        jm.VGAEModel.kl_loss(a, b / 4)))(z1, z2, EI, neg)
    got = (tm.grace_loss(_t(z1), _t(z2), 0.7),
           tm.inner_product_decoder(_t(z1), _t(EI), True),
           tm.inner_product_decoder(_t(z1), _t(EI), False),
           tm.recon_loss(_t(z1), _t(EI), _t(neg)),
           tm.VGAEModel.kl_loss(_t(z1), _t(z2 / 4)))
    for a, b in zip(got, want):
        _check(a, b, TOL)


def test_laplacian_eigh_and_eig_encoding_match_jax():
    for k in (None, 5):
        want = jm.laplacian_eigh(EI, N, k)
        got = tm.laplacian_eigh(EI, N, k)
        if k is None:  # the same LAPACK call on the same matrix
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:  # eigsh's start vector is random: the values only
            np.testing.assert_allclose(np.sort(got[0]), np.sort(want[0]),
                                       atol=1e-5)
    lam = jm.laplacian_eigh(EI, N)[0]
    want = _EigEncoding(HID).apply({}, jnp.asarray(lam))
    got = _eig_encoding(_t(lam), HID)
    assert got.shape == (N, 1 + 2 * (HID // 2))
    _check(got, want, TOL)
    assert _eig_encoding(_t(lam), 9).shape == (N, 9)


def test_specformer_dropout_draws_from_the_generator():
    """Training mode with dropout: one generator state gives one output,
    and the output differs from the eval forward."""
    model = tm.SpecformerModel(3, HID, num_filters=2, drop_rate=0.5)
    lam, u = (_t(a) for a in tm.laplacian_eigh(EI, N))
    model.train()
    outs = [model(_t(X), lam, u, torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], model.eval()(_t(X), lam, u))


def test_models_own_init_runs_lazy():
    """The port's own init (lazy first maps): finite outputs and losses
    that backpropagate."""
    tx, tei = _t(X), _t(EI)
    g = torch.Generator().manual_seed(0)
    xc = tm.corrupt_features(tx, g)
    for model, inputs in (
            (tm.DGIModel(HID), (tx, tei, xc)),
            (tm.GGDModel(HID), (tx, tei, xc)),
            (tm.MVGRLModel(HID), (tx, tei, tei, torch.ones(EI.shape[1]), xc)),
            (tm.GraceModel(HID, HID), (tx, tei, None, tx, tei, None))):
        loss = model(*inputs)
        loss.backward()
        assert torch.isfinite(loss)
    mu, logstd, z = tm.VGAEModel(HID, 8)(tx, tei, generator=g)
    assert not torch.equal(mu, z)
    assert torch.isfinite(tm.MGNNIModel(3, HID, iters=3)(tx, tei)).all()


def test_grace_zero_row_gradient_is_finite():
    """ROADMAP C28. With the drawn view masks node N-1 loses its only
    in-edge (its self-loop), so its rows of the encoder and the
    projection are exactly 0 at init (zero biases). JAX's `grace_loss`
    normalises by ``jnp.linalg.norm``, whose derivative at 0 is NaN: every
    JAX gradient is NaN. The port's ``vector_norm`` has gradient 0 there:
    the loss is JAX's and the gradients are finite."""
    fm1, em1 = _views(jax.random.PRNGKey(6), 0.2, 0.3)
    fm2, em2 = _views(jax.random.PRNGKey(7), 0.4, 0.1)
    assert not em1[-1]
    x1, w1 = X * fm1, em1.astype(np.float32)
    x2, w2 = X * fm2, em2.astype(np.float32)
    jmod = jm.GraceModel(HID, HID)
    ei = jnp.asarray(EI)
    params = jax.jit(jmod.init)(KEY, x1, ei, w1, x2, ei, w2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmod.apply(p, x1, ei, w1, x2, ei, w2)))(params)
    assert np.isnan(np.asarray(grads["params"]["Dense_0"]["kernel"])).all()
    model = load_jax_params(tm.GraceModel(HID, HID), _np_tree(params))
    tei = _t(EI)
    got = model(_t(x1), tei, _t(w1), _t(x2), tei, _t(w2))
    with torch.no_grad():
        z1 = model.proj(model.enc(_t(x1), tei, _t(w1)))
    assert float(z1[-1].abs().max()) == 0.0
    got.backward()
    _check(got, loss, TOL)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None)
