"""The port's first four A6e model modules (`models/embedding.py`,
`gan_distill.py`, `seal_cogsl.py`, `defog.py`) against the JAX package's.

Each model is built in JAX with its own ``init``, carried across with
`load_jax_params`, and fed the same numpy inputs (from a seed): outputs
and losses at rtol 1e-5, atol 1e-6; the gradients of a loss of them in
every parameter at rtol 1e-4, atol 1e-6 (float32). Each JAX reference is
compiled once for the module (cached). Host numpy parts are bitwise: the
walks, `drnl_node_labeling`, `herec`, and DeFoG's noising and sampler
step on the draws `jax.random` makes from the same key (the port draws
independently, ROADMAP C40; its pure parts take JAX's draws).
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
from gammagl_tpu.loader.random_walk import (  # noqa: E402
    RandomWalkLoader as JaxWalks)
from tests.test_torch_simple_convs import _flat, _np_tree  # noqa: E402

import gammagl_tpu_torch.models as tm  # noqa: E402
from gammagl_tpu_torch.models import defog as tdefog  # noqa: E402
from gammagl_tpu_torch.models.seal_cogsl import (  # noqa: E402
    cogsl_confidence)
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402
from gammagl_tpu_torch.utils.params import _layout  # noqa: E402

KEY = jax.random.PRNGKey(5)
N, HID = 24, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rtol=1e-5, atol=1e-6):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _grads_close(module, jax_grads):
    """The port's parameter gradients under their flax names (kernels
    transposed back; one the loss does not reach is zeros, as in JAX)
    against jax.grad's, rtol 1e-4, atol 1e-6."""
    want = dict(_flat(jax_grads["params"]))
    got = {}
    for path, (p, perm) in _layout(module).items():
        g = (np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.detach().numpy())
        got["/".join(path)] = g.transpose(perm) if perm else g
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], 1e-4, 1e-6)


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a) if dtype is None
                            else np.asarray(a, dtype))


def _cot(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dot(out, cot):
    """sum(out * cot) in either package."""
    if isinstance(out, torch.Tensor):
        return (out * _t(cot)).sum()
    return jnp.sum(out * cot)


def _walk_inputs(seed=1, n=N, B=6, L=5, K=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (B, L)), rng.integers(0, n, (B, K, L)))


def _seal_batch(seed=2, graphs=3, with_x=False):
    """Three DRNL-labeled subgraphs batched, padded to static sizes as the
    seal twin pads: padded nodes in segment ``graphs`` (out of range),
    padded edges a self-loop of the last row."""
    rng = np.random.default_rng(seed)
    labels, eis, batch, off = [], [], [], 0
    for g in range(graphs):
        n = 5 + g
        ei = np.stack([rng.integers(0, n, 9), rng.integers(0, n, 9)])
        labels.append(tm.drnl_node_labeling(ei, n, 0, 1))
        eis.append(ei + off)
        batch += [g] * n
        off += n
    cap_n, cap_e = off + 4, 40
    ei = np.concatenate(eis, 1)
    ei = np.concatenate([ei, np.full((2, cap_e - ei.shape[1]), cap_n - 1)],
                        1)
    lab = np.concatenate(labels + [np.zeros(4, np.int64)])
    b = np.asarray(batch + [graphs] * 4)
    x = rng.normal(size=(cap_n, 3)).astype(np.float32) if with_x else None
    return lab, ei, b, x, graphs


def _cogsl_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 6)).astype(np.float32)
    e1 = np.stack([rng.integers(0, N, 60), rng.integers(0, N, 60)])
    e1 = np.concatenate([e1, np.stack([np.arange(N)] * 2)], 1)
    e2 = e1[::-1].copy()[:, 20:]
    return x, e1, e2


def _defog_dims(n_layers=1):
    return dict(n_layers=n_layers, input_dims={"X": 4, "E": 3, "y": 1 + 64},
                hidden_mlp_dims={"X": 16, "E": 8, "y": 16},
                hidden_dims={"dx": 16, "de": 8, "dy": 16, "n_head": 2},
                output_dims={"X": 4, "E": 3, "y": 1})


def _defog_graph(seed=4, n=7):
    rng = np.random.default_rng(seed)
    X = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    e = rng.integers(0, 3, (n, n))
    e = np.triu(e) + np.triu(e, 1).T
    E = np.eye(3, dtype=np.float32)[e]
    mask = np.ones(n, bool)
    mask[-2:] = False
    return X, E, np.zeros(1, np.float32), mask


def _cases():
    pos, neg = _walk_inputs()
    mp = (("movie", "by", "director"), ("director", "directs", "movie"))
    nd = {"movie": 14, "director": 10}
    mpos, mneg = _walk_inputs(7, n=24)
    rng = np.random.default_rng(8)
    u, v = rng.integers(0, N, 16), rng.integers(0, N, 16)
    lab = (np.arange(16) % 2).astype(np.float32)
    x = _cot((N, 6), 9)
    xl, xei, xb, sx, xg = _seal_batch(with_x=True)
    cx, ce1, ce2 = _cogsl_inputs()
    DX, DE, Dy, Dm = _defog_graph()
    dt = np.float32(0.3)
    ident = (lambda out: out, lambda out: out)

    def cogsl_loss(out):
        (l1, l2, lf), mi = out
        return (_dot(l1, _cot((N, 3), 11)) + _dot(l2, _cot((N, 3), 12))
                + _dot(lf, _cot((N, 3), 13)) + mi)

    def defog_loss(out):
        return (_dot(out[0], _cot(DX.shape, 14)) + _dot(
            out[1], _cot(DE.shape, 15)) + _dot(out[2], _cot((1,), 16)))

    def xey_loss(out):
        return (_dot(out[0], _cot((7, 16), 17)) + _dot(
            out[1], _cot((7, 7, 8), 18)) + _dot(out[2], _cot((16,), 19)))

    X16, E8, y16 = _cot((7, 16), 20), _cot((7, 7, 8), 21), _cot((16,), 22)
    return {
        "node2vec": (jm.Node2Vec(N, HID, context_size=4), (pos, neg),
                     tm.Node2Vec(N, HID, context_size=4), (_t(pos),
                                                           _t(neg)),
                     *ident),
        "deepwalk": (jm.DeepWalk(N, HID), (pos, neg), tm.DeepWalk(N, HID),
                     (_t(pos), _t(neg)), *ident),
        "metapath2vec": (jm.MetaPath2Vec(nd, mp, HID, walk_length=4,
                                         context_size=3), (mpos, mneg),
                         tm.MetaPath2Vec(nd, mp, HID, walk_length=4,
                                         context_size=3),
                         (_t(mpos), _t(mneg)), *ident),
        "graphgan_d": (jm.GraphGAN(N, HID), (u, v, lab),
                       tm.GraphGAN(N, HID), (_t(u), _t(v), _t(lab)),
                       *ident),
        "graphgan_g": (jm.GraphGAN(N, HID), (u, v), tm.GraphGAN(N, HID),
                       (_t(u), _t(v)), *ident),
        "glnn": (jm.GLNNStudent(HID, 3, num_layers=3), (x,),
                 tm.GLNNStudent(HID, 3, num_layers=3), (_t(x),),
                 *(lambda out: _dot(out, _cot((N, 3), 10)),) * 2),
        "seal_x": (jm.SEALModel(HID, max_label=4, k=5),
                   (xl, xei, sx, xb, xg),
                   tm.SEALModel(HID, max_label=4, k=5, in_channels=3),
                   (_t(xl), _t(xei), _t(sx), _t(xb), xg),
                   *(lambda out: _dot(out, _cot((xg, 1), 24)),) * 2),
        "cogsl": (jm.CoGSLModel(3, HID), (cx, ce1, ce2),
                  tm.CoGSLModel(3, HID), (_t(cx), _t(ce1), _t(ce2)),
                  cogsl_loss, cogsl_loss),
        "defog": (jm.DeFoGModel(**_defog_dims()), (DX, DE, Dy, dt, Dm),
                  tm.DeFoGModel(**_defog_dims()),
                  (_t(DX), _t(DE), _t(Dy), torch.tensor(dt), _t(Dm)),
                  defog_loss, defog_loss),
        "xey": (jm.XEyTransformerLayer(16, 8, 16, 2), (X16, E8, y16, Dm),
                tm.XEyTransformerLayer(16, 8, 16, 2),
                (_t(X16), _t(E8), _t(y16), _t(Dm)), xey_loss, xey_loss),
    }


CASES = _cases()


def _jnp(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's init tree, output and the gradients of its loss, the
    loss and its gradients compiled once."""
    jmod, jin, _, _, jloss, _ = CASES[name]
    jin = tuple(a if isinstance(a, int) else _jnp(a) for a in jin)
    static = tuple(i for i, a in enumerate(jin) if isinstance(a, int))
    params = jmod.init(KEY, *jin)

    def loss(p, *a):
        out = jmod.apply(p, *a)
        return jloss(out), out

    fn = jax.grad(loss, has_aux=True)
    if not name.startswith("seal"):  # sort pooling sizes its batch on
        fn = jax.jit(fn, static_argnums=tuple(s + 1 for s in static))
    grads, out = fn(params, *jin)  # the host: the seal twin runs eagerly
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


def _leaves(out):
    return jax.tree_util.tree_leaves(out) if not isinstance(
        out, torch.Tensor) else [out]


def _torch_leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _torch_leaves(o)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_output_and_grads_match_jax(name):
    _, _, tmod, tin, _, tloss = CASES[name]
    params, want, grads = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    model.zero_grad(set_to_none=True)
    out = model(*tin)
    tloss(out).backward()
    got = _torch_leaves(out)
    want = _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    _grads_close(model, grads)


def test_graphgan_scores_and_reward_overflow_follow_jax():
    """The discriminator and generator scores (the methods the twin
    reads), and the reward log1p(exp(s)): at s past ~88 it is inf in
    float32 in both packages, and so is the generator loss."""
    jmod, _, tmod, _, _, _ = CASES["graphgan_g"]
    params = _jax_case("graphgan_g")[0]
    model = load_jax_params(tmod, params)
    u, v = np.arange(6), np.arange(6)[::-1].copy()
    for meth in ("gen_score", "dis_score"):
        want = jmod.apply(params, jnp.asarray(u), jnp.asarray(v),
                          method=getattr(jm.GraphGAN, meth))
        _close(getattr(model, meth)(_t(u), _t(v)), want)
    params["params"]["dis_bias"] = params["params"]["dis_bias"] + 100.0
    want = jmod.apply(params, jnp.asarray(u), jnp.asarray(v))
    got = load_jax_params(tmod, params)(_t(u), _t(v))
    got = float(got.detach())
    assert np.isinf(float(want)) and np.isinf(got)
    assert float(want) > 0 and got > 0


def test_distill_loss_and_herec_match_jax():
    s, t = _cot((N, 4), 30), _cot((N, 4), 31)
    y = np.random.default_rng(32).integers(0, 4, N)
    mask = np.arange(N) % 3 == 0
    for lam, temp in ((0.5, 1.0), (0.3, 2.0)):
        ts = _t(s).requires_grad_()
        got = tm.distill_loss(ts, _t(t), _t(y), _t(mask), lam, temp)
        got.backward()
        want, gs = jax.value_and_grad(jm.distill_loss)(
            jnp.asarray(s), jnp.asarray(t), jnp.asarray(y),
            jnp.asarray(mask), lam, temp)
        _close(got, want)
        _close(ts.grad, gs, 1e-4, 1e-6)
    embs = [_cot((N, 3), 33 + i) for i in range(3)]
    np.testing.assert_array_equal(tm.herec([_t(e) for e in embs]),
                                  jm.herec(embs))


def test_walks_are_jax_bitwise():
    """`Node2Vec.make_loader` (DeepWalk's too) gives the JAX loader's
    batches under one seed; `MetaPath2Vec.sample_walks` the JAX draws
    under one numpy generator; the per-type offsets and `embed`."""
    rng = np.random.default_rng(40)
    ei = np.stack([rng.integers(0, N, 70), rng.integers(0, N, 70)])
    for cls_t, cls_j, kw in ((tm.Node2Vec, jm.Node2Vec, {"p": 4.0}),
                             (tm.DeepWalk, jm.DeepWalk, {})):
        a = cls_t(N, HID, walk_length=5, num_negatives=2, **kw).make_loader(
            ei, batch_size=10, seed=3)
        b = cls_j(N, HID, walk_length=5, num_negatives=2, **kw).make_loader(
            ei, batch_size=10, seed=3)
        assert isinstance(b, JaxWalks)
        for (pa, na), (pb, nb) in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
            np.testing.assert_array_equal(na, nb)
    _, _, tmod, _, _, _ = CASES["metapath2vec"]
    jmod = CASES["metapath2vec"][0]
    eid = {("movie", "by", "director"): np.stack(
               [np.arange(14), rng.integers(0, 10, 14)]),
           ("director", "directs", "movie"): np.stack(
               [rng.integers(0, 9, 20), rng.integers(0, 14, 20)])}
    starts = np.arange(14)
    got = tmod.sample_walks(eid, starts, np.random.default_rng(5))
    want = jmod.sample_walks(eid, starts, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    assert tmod.offsets == jmod.offsets
    params = _jax_case("metapath2vec")[0]
    model = load_jax_params(tmod, params)
    for nt in ("movie", "director"):
        np.testing.assert_array_equal(
            model.embed(nt, _t(np.array([0, 3]))).detach().numpy(),
            jmod.apply(params, nt, jnp.array([0, 3]),
                       method=jm.MetaPath2Vec.embed))


@pytest.mark.parametrize("max_dist", [1, 2, 10])
def test_drnl_labels_are_jax_bitwise(max_dist):
    """Random subgraphs, the targets adjacent or not, a node reachable
    only through the other target (blocked in each search), and nodes
    out of reach."""
    rng = np.random.default_rng(41 + max_dist)
    for trial in range(6):
        n = 12
        ei = np.stack([rng.integers(0, n - 2, 14), rng.integers(0, n - 2,
                                                               14)])
        if trial % 2:
            ei = np.concatenate([ei, [[0], [1]]], 1)
        ei = np.concatenate([ei, [[1], [n - 3]]], 1)  # a leaf behind dst
        got = tm.drnl_node_labeling(ei, n, 0, 1, max_dist)
        want = jm.drnl_node_labeling(ei, n, 0, 1, max_dist)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_cogsl_confidence_at_ties_follows_top_k():
    """`jax.lax.top_k` puts the lower index first among equal values; the
    port picks the same two entries, so the margin's gradient reaches the
    same logits at a three-way tie, a tie for second place and a row of
    equal logits (a row without edges at init). Then the fused weight
    w1 = c1 / (c1 + c2 + 1e-12) where both views tie (c1 = c2 = 0): the
    1e-12 keeps it 0, and its gradient, 1e12 times the margin's, is the
    same in both packages. (In the model such a row has a zero
    embedding, where JAX's GRACE loss gives NaN gradients, C28.)"""
    logits = np.array([[0.5, 1.0, 1.0, 1.0], [2.0, 0.0, 1.0, 1.0],
                       [0.0, 0.0, 0.0, 0.0], [3.0, 1.0, -1.0, 2.0]],
                      np.float32)
    cot = _cot((4,), 42)

    def jconf(lg):
        p = jax.nn.softmax(lg, -1)
        top2 = jax.lax.top_k(p, 2)[0]
        return top2[:, 0] - top2[:, 1]

    want, wgrad = jax.value_and_grad(
        lambda lg: jnp.sum(jconf(lg) * cot))(jnp.asarray(logits))
    tl = _t(logits).requires_grad_()
    got = (cogsl_confidence(tl) * _t(cot)).sum()
    got.backward()
    _close(got, want)
    np.testing.assert_array_equal(tl.grad.numpy() != 0,
                                  np.asarray(wgrad) != 0)
    _close(tl.grad, wgrad, 1e-4, 1e-6)

    a = _cot((4,), 43)

    def jfused(l1, l2):
        c1, c2 = jconf(l1), jconf(l2)
        return jnp.sum(c1 / (c1 + c2 + 1e-12) * a)

    tied = np.zeros((4, 4), np.float32)
    tied[0] = [1.0, 2.0, 0.0, 0.0]  # one row with a margin
    want, wg = jax.value_and_grad(jfused, argnums=(0, 1))(
        jnp.asarray(tied), jnp.asarray(tied))
    l1, l2 = (_t(tied).requires_grad_() for _ in range(2))
    c1, c2 = cogsl_confidence(l1), cogsl_confidence(l2)
    got = (c1 / (c1 + c2 + 1e-12) * _t(a)).sum()
    got.backward()
    _close(got, want)
    for g, w in zip((l1.grad, l2.grad), wg):
        assert np.isfinite(np.asarray(w)).all()
        _close(g, w, 1e-4, 1e-6)


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 0.25, 0.9], np.float32)
    for dim in (64, 7):
        _close(tm.timestep_embedding(_t(t), dim),
               jm.timestep_embedding(jnp.asarray(t), dim))


def _flow_draws_jax(rng, N, dX, dE, t):
    """The draws `flow_interpolate` makes from ``rng`` (defog.py:138-145):
    the keep mask and the resampled class from one key each."""
    kx, ke = jax.random.split(rng)
    return {"keep_x": jax.random.bernoulli(kx, t, (N,)),
            "rand_x": jax.random.randint(kx, (N,), 0, dX),
            "keep_e": jax.random.bernoulli(ke, t, (N, N)),
            "rand_e": jax.random.randint(ke, (N, N), 0, dE)}


def _euler_draws_jax(rng, px, pe, t, dt):
    """The draws `euler_sample_step` makes (defog.py:159-168)."""
    kx, ke = jax.random.split(rng)
    jump_p = jnp.clip(dt / jnp.maximum(1 - t, dt), 0.0, 1.0)
    N = px.shape[0]
    return {"new_x": jax.random.categorical(kx, px),
            "jump_x": jax.random.bernoulli(kx, jump_p, (N,)),
            "new_e": jax.random.categorical(ke, pe),
            "jump_e": jax.random.bernoulli(ke, jump_p, (N, N))}


def _torch_draws(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("t", [0.2, 0.7])
def test_flow_interpolate_on_jax_draws_is_bitwise(t):
    """The port's noising on the draws JAX makes from the key gives JAX's
    (Xt, Et) bit for bit; half-weights stand where two resampled
    one-hots differ, and the keep mask is symmetric (a bool
    triu + triu(., 1).T)."""
    X0, E0, _, _ = _defog_graph(50, n=9)
    rng = jax.random.PRNGKey(int(t * 10))
    want = jm.flow_interpolate(rng, jnp.asarray(X0), jnp.asarray(E0), t)
    draws = _flow_draws_jax(rng, 9, 4, 3, t)
    got = tdefog.flow_interpolate_apply(_torch_draws(draws), _t(X0),
                                        _t(E0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    Et = got[1].numpy()
    assert (Et == 0.5).any()
    keep = np.asarray(draws["keep_e"])
    sym = np.triu(keep) | np.triu(keep, 1).T
    np.testing.assert_array_equal(Et[sym], E0[sym])


def test_euler_step_on_jax_draws_is_bitwise():
    """The sampler step on JAX's draws gives JAX's (Xn, En) bit for bit;
    the resampled edge classes are symmetric (an integer
    triu + triu(., 1).T)."""
    Xt, Et, _, _ = _defog_graph(51, n=9)
    px, pe = _cot((9, 4), 52), _cot((9, 9, 3), 53)
    for t, dt in ((0.2, 0.1), (0.95, 0.1)):
        rng = jax.random.PRNGKey(7)
        args = (jnp.asarray(Xt), jnp.asarray(Et), jnp.asarray(px),
                jnp.asarray(pe), t, dt)
        want = jm.euler_sample_step(rng, *args)
        draws = _euler_draws_jax(rng, jnp.asarray(px), jnp.asarray(pe), t,
                                 dt)
        got = tdefog.euler_apply(_torch_draws(draws), _t(Xt), _t(Et))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        cls = got[1].numpy().argmax(-1)
        jump = np.asarray(draws["jump_e"])
        sym = np.triu(jump) | np.triu(jump, 1).T
        assert (cls[sym] == cls.T[sym]).all()


def test_port_draws_follow_their_laws():
    """The port's own draws (ROADMAP C40: independent, from a
    `torch.Generator`): t = 1 keeps the clean graph, t = 0 resamples all;
    a step with dt >= 1 - t jumps everywhere, to symmetric edges."""
    X0, E0, _, _ = _defog_graph(54, n=9)
    g = torch.Generator().manual_seed(0)
    X1, E1 = tm.flow_interpolate(g, _t(X0), _t(E0), 1.0)
    assert torch.equal(X1, _t(X0)) and torch.equal(E1, _t(E0))
    d = tdefog.flow_draws(g, 9, 4, 3, 0.0)
    assert not d["keep_x"].any() and not d["keep_e"].any()
    px, pe = _t(_cot((9, 4), 55)), _t(_cot((9, 9, 3), 56))
    Xn, En = tm.euler_sample_step(g, _t(X0), _t(E0), px, pe, 0.5, 0.5)
    d = tdefog.euler_draws(g, px, pe, 0.5, 0.5)
    assert d["jump_x"].all() and d["jump_e"].all()
    assert torch.equal(En, En.transpose(0, 1))
    assert torch.equal(Xn.sum(-1), torch.ones(9))


def test_models_own_init_runs():
    """The port's own init (lazy first maps where flax infers them):
    finite outputs and losses that backpropagate."""
    pos, neg = _walk_inputs()
    sl, sei, sb, _, sg = _seal_batch()
    cx, ce1, ce2 = _cogsl_inputs()
    DX, DE, Dy, _ = _defog_graph()
    for model, inputs in (
            (tm.Node2Vec(N, HID), (_t(pos), _t(neg))),
            (tm.GLNNStudent(HID, 3), (_t(cx),)),
            (tm.SEALModel(HID, k=6), (_t(sl), _t(sei), None, _t(sb), sg)),
            (tm.CoGSLModel(3, HID), (_t(cx), _t(ce1), _t(ce2))),
            (tm.DeFoGModel(**_defog_dims(2)), (_t(DX), _t(DE), _t(Dy),
                                               0.5))):
        model.train()
        leaves = _torch_leaves(model(*inputs))
        sum(o.sum() for o in leaves).backward()
        assert all(torch.isfinite(o).all() for o in leaves)
