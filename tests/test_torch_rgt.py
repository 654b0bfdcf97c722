"""RGT in the port (`utils/manifold_math.py`, `layers/conv/rgt_layers.py`,
`layers/conv/rgt_vq.py`, `layers/attention/rgt.py`, `models/rgt.py`)
against the JAX package's.

Every manifold function and method on the same numpy points (inside the
ball, near its edge and on the clamps): values at 1e-5 of max |out|,
input gradients at 1e-4 of max |grad| (JAX eager, no compile). The
layers, the vector quantisers, the structure learners and RGT's
`train_loss` at ``n_layers=2`` and narrow widths, from JAX init trees:
outputs at 1e-5, parameter gradients at 1e-4, the codebook indices
equal. The structure buffers come from the JAX `build_structure_batch`
(`tests/test_torch_rgt_loader.py` holds the port's bitwise). The RGT
reference compiles once for the module.
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
import gammagl_tpu.utils.manifold_math as jmm  # noqa: E402
from gammagl_tpu.layers import attention as ja  # noqa: E402
from gammagl_tpu.layers.conv import rgt_layers as jl  # noqa: E402
from gammagl_tpu.layers.conv import rgt_vq as jv  # noqa: E402
from gammagl_tpu.loader.rgt_loader import (  # noqa: E402
    build_structure_batch as jax_structures)
from gammagl_tpu.models.rgt import RGTModel as JaxRGT  # noqa: E402
from gammagl_tpu.models.rgt import rgt_cl_loss as jax_cl_loss  # noqa: E402
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _flat, _np_tree)

import gammagl_tpu_torch.utils.manifold_math as tmm  # noqa: E402
from gammagl_tpu_torch.layers import attention as ta  # noqa: E402
from gammagl_tpu_torch.layers.conv import rgt_layers as tl  # noqa: E402
from gammagl_tpu_torch.layers.conv import rgt_vq as tv  # noqa: E402
from gammagl_tpu_torch.models import RGTModel, rgt_cl_loss, rgt_loss  # noqa
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402
from gammagl_tpu_torch.utils.params import _layout  # noqa: E402

TOL, GTOL = 1e-5, 1e-4
KEY = jax.random.PRNGKey(6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- points ---------------------------------------------------------------

RNG = np.random.default_rng(0)
D = 6


def _ball(n, radius, seed):
    v = np.random.default_rng(seed).normal(size=(n, D))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = np.random.default_rng(seed + 1).random((n, 1)) * radius
    return (v * r).astype(np.float32)


BALL = np.concatenate([_ball(6, 0.7, 1),
                       _ball(2, 1.0, 3) / np.float32(1.0000001),
                       # at the ball's edge and past it: project clips
                       np.full((1, D), 0.45, np.float32)])
TAN = _cot((9, D), 2) * np.float32(0.6)
SPH = _cot((9, D), 4)
SPH /= np.linalg.norm(SPH, axis=1, keepdims=True)
SPH[-1] = -SPH[0]  # an antipodal pair: cos clamps at -1 + 1e-6
SPH[-2] = SPH[0]   # a repeated point: cos clamps at 1 - 1e-6
LOR_S = _cot((9, D - 1), 5)
LOR_S[-1] = 0.0    # the origin
LOR = np.concatenate([np.sqrt(1 + (LOR_S ** 2).sum(1, keepdims=True)),
                      LOR_S], 1).astype(np.float32)
# time exactly at logmap0's clamp, 1 + 1e-7 in float32: a tie with the
# bound, where JAX's maximum passes half the gradient (ROADMAP C34)
LOR_TIE = np.array([[np.float32(1.0 + 1e-7)] + [0.3] * (D - 1)],
                   np.float32)
CODES = _cot((5, D), 6)
CODES /= np.linalg.norm(CODES, axis=1, keepdims=True)


def _man(pkg, name):
    return getattr(pkg, name)()


def _fns():
    """name -> (JAX function, port function, inputs): each function of the
    module and each manifold method on its points."""
    c = 0.8
    fns = {
        "project": (lambda m, x: m.project(x, c), [BALL * 1.3]),
        "mobius_add": (lambda m, x, y: m.mobius_add(x, y, c),
                       [BALL, BALL[::-1].copy()]),  # row 4 with itself
        "expmap": (lambda m, v, x: m.expmap(v, x, c), [TAN * 0.5, BALL]),
        # no pair of equal points: the Poincare norms of a zero row have
        # NaN gradients in JAX (C35, test_norm_at_zero_differs_on_purpose)
        "logmap": (lambda m, y, x: m.logmap(y, x, c),
                   [BALL, np.roll(BALL, 3, axis=0)]),
        "expmap0": (lambda m, v: m.expmap0(v, c), [TAN]),
        "logmap0": (lambda m, y: m.logmap0(y, c), [BALL]),
        "poincare_distance": (lambda m, x, y: m.poincare_distance(x, y, c),
                              [BALL, np.roll(BALL, 3, axis=0)]),
        "poincare_c_1": (lambda m, x, y: m.mobius_add(
            m.expmap0(x, 1.0), y, 1.0), [TAN * 0.3, BALL]),
    }
    for man, pts, extra in (
            ("EuclideanM", BALL, {}),
            ("SphereM", SPH, {
                "origin_like": lambda m, x: m.origin_like(x),
                "expmap": lambda m, x, u: m.expmap(x, m.proju(x, u)),
                "logmap": lambda m, x, y: m.logmap(x, y),
                "pairwise_dist": lambda m, x, y: m.pairwise_dist(x, y[:5]),
                "transp": lambda m, x, y, u: m.transp(x, y, u)}),
            ("LorentzM", LOR, {
                "origin_like": lambda m, x: m.origin_like(x),
                "expmap": lambda m, x, u: m.expmap(x, m.proju(x, u)),
                "pairwise_dist": lambda m, x, y: m.pairwise_dist(x, y[:5]),
                "logmap0_tie": lambda m, x: m.logmap0(x)})):
        other = pts[::-1].copy()
        base = {
            "expmap0": (lambda m, u: m.expmap0(m.proju0(u)), [TAN]),
            "logmap0": (lambda m, x: m.logmap0(x), [pts]),
            "proju": (lambda m, x, u: m.proju(x, u), [pts, TAN]),
            "proju0": (lambda m, u: m.proju0(u), [TAN]),
            "projx": (lambda m, x: m.projx(x), [TAN]),
            "transp0back": (lambda m, x, u: m.transp0back(x, u), [pts, TAN]),
            "inner": (lambda m, x, u: m.inner(x, u, keepdim=True),
                      [pts, TAN]),
            "inner_uv": (lambda m, u, v: m.inner(None, u, v), [TAN, other]),
            "cinner": (lambda m, x, y: m.cinner(x, y), [pts, other]),
            "cinner_pairs": (lambda m, x, y: m.cinner(x, y[:4]),
                             [pts, other]),
            "norm": (lambda m, u: m.norm(u, keepdim=True), [TAN]),
            "dist": (lambda m, x, y: m.dist(x, y), [pts, other]),
            "dist_keep": (lambda m, x, y: m.dist(x, y, keepdim=True),
                          [pts, other]),
            "frechet_mean": (lambda m, x: m.frechet_mean(
                x, (np.arange(9) % 4).astype(np.int32)
                if isinstance(x, np.ndarray) else None, 4), [pts]),
        }
        for name, f in extra.items():
            n_in = f.__code__.co_argcount - 1
            base[name] = (f, [LOR_TIE if name == "logmap0_tie" else pts,
                              other, TAN][:n_in])
        if man == "SphereM":
            # the log map at an antipode has no value (every direction is
            # a geodesic); both packages return rounding noise there, so
            # its pairs are pts[i] and pts[i + 3], none antipodal
            base["logmap"] = (base["logmap"][0],
                              [pts, np.roll(pts, 3, axis=0)])
        for name, (f, args) in base.items():
            fns[f"{man}.{name}"] = ((lambda f, man: lambda pkg, *a: f(
                _man(pkg, man), *a))(f, man), args)
    prod = lambda pkg: pkg.ProductM((pkg.LorentzM(), 3),  # noqa: E731
                                    (pkg.SphereM(), 3))
    prod_pts = np.concatenate([LOR[:, :3] * 0 + np.concatenate(
        [np.sqrt(1 + (LOR_S[:, :2] ** 2).sum(1, keepdims=True)),
         LOR_S[:, :2]], 1), SPH[:, :3] / np.linalg.norm(
        SPH[:, :3], axis=1, keepdims=True)], 1).astype(np.float32)
    fns["ProductM.logmap0"] = (lambda pkg, x: prod(pkg).logmap0(x),
                               [prod_pts])
    fns["ProductM.proju0"] = (lambda pkg, u: prod(pkg).proju0(u), [TAN])
    fns["ProductM.expmap0"] = (lambda pkg, u: prod(pkg).expmap0(
        prod(pkg).proju0(u)), [TAN])
    fns["ProductM.frechet_mean"] = (lambda pkg, x: prod(pkg).frechet_mean(
        x, _ids(pkg), 4, _w(pkg)), [prod_pts])
    return fns


def _ids(pkg):
    ids = (np.arange(9) % 4).astype(np.int32)
    return jnp.asarray(ids) if pkg is jmm else _t(ids)


def _w(pkg):
    w = np.linspace(0.5, 1.5, 9, dtype=np.float32)[:, None]
    return jnp.asarray(w) if pkg is jmm else _t(w)


FNS = _fns()


def _run(pkg, name):
    """Values and input gradients of sum(out * g) of the case in pkg."""
    f, args = FNS[name]
    if "frechet_mean" in name and not name.startswith("ProductM"):
        man = name.split(".")[0]

        def f(pkg_, x, man=man):
            return getattr(pkg_, man)().frechet_mean(x, _ids(pkg_), 4)
    if pkg is jmm:
        out, vjp = jax.vjp(lambda *a: f(jmm, *a),
                           *(jnp.asarray(a) for a in args))
        g = _cot(out.shape, 9)
        return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]
    ins = [_t(a).requires_grad_() for a in args]
    out = f(tmm, *ins)
    if out.requires_grad:
        (out * _t(_cot(tuple(out.shape), 9))).sum().backward()
    return out.detach().numpy(), [
        np.zeros(a.shape, np.float32) if a.grad is None else a.grad.numpy()
        for a in ins]


@pytest.mark.parametrize("name", sorted(FNS))
def test_manifold_function_matches_jax(name):
    want, wgrads = _run(jmm, name)
    got, grads = _run(tmm, name)
    assert got.shape == want.shape
    _check(got, want, TOL)
    for g, w in zip(grads, wgrads):
        assert np.isfinite(w).all()
        if np.abs(w).max() > 0:
            _check(g, w, GTOL)
        else:
            np.testing.assert_array_equal(g, w)


def test_clip_follows_jax_at_its_bounds():
    """ROADMAP C34: ``jnp.clip`` and ``.clip`` pass half the gradient to
    an input exactly on a bound (a maximum, then a minimum); the port's
    `_clip` does too, where ``torch.clamp`` would pass all of it."""
    for lo, hi, at in ((0.0, 1.0, 0.0), (0.0, 1.0, 1.0), (1e-7, None, 1e-7),
                       (-1.0 + 1e-6, 1.0 - 1e-6, 1.0 - 1e-6)):
        want = jax.grad(lambda v: jnp.clip(v, lo, hi))(jnp.float32(at))
        x = torch.tensor(at, dtype=torch.float32, requires_grad=True)
        tmm._clip(x, lo, hi).backward()
        assert float(x.grad) == float(want) == 0.5
        y = torch.tensor(at, dtype=torch.float32, requires_grad=True)
        y.clamp(lo, hi).backward()
        assert float(y.grad) == 1.0


def test_norm_at_zero_differs_on_purpose():
    """ROADMAP C35: the Poincare maps take ``jnp.linalg.norm`` (then
    clip it), whose gradient at a zero row is NaN in JAX; the port's
    `torch.linalg.vector_norm` gives 0 there, so the port's gradient is
    finite. The values agree."""
    v = np.zeros((2, D), np.float32)
    v[1] = 0.2
    for jf, tf in ((lambda a: jmm.expmap0(a, 1.0),
                    lambda a: tmm.expmap0(a, 1.0)),
                   (lambda a: jmm.logmap0(a, 1.0),
                    lambda a: tmm.logmap0(a, 1.0))):
        want, vjp = jax.vjp(jf, jnp.asarray(v))
        (jg,) = vjp(jnp.ones_like(want))
        assert np.isnan(np.asarray(jg)[0]).all()
        x = _t(v).requires_grad_()
        out = tf(x)
        out.sum().backward()
        _check(out, want, TOL)
        assert torch.isfinite(x.grad).all()
        _check(x.grad[1], np.asarray(jg)[1], GTOL)


def test_manifolds_compare_by_type_and_curvature():
    assert tmm.SphereM() == tmm.SphereM() != tmm.LorentzM()
    assert hash(tmm.LorentzM()) == hash(tmm.LorentzM())
    p = tmm.ProductM((tmm.LorentzM(), 3), (tmm.SphereM(), 3))
    assert p == tmm.ProductM((tmm.LorentzM(), 3), (tmm.SphereM(), 3))
    assert p != tmm.ProductM((tmm.SphereM(), 3), (tmm.LorentzM(), 3))


# -- layers, VQ, attention -------------------------------------------------

N, FEAT, EMB, HID = 18, 10, 8, 12
SEEDS = 3


def _batch():
    """A sampled-batch stand-in: N nodes (the last 4 zero padding), its
    edges, and the JAX loader's structure buffers for SEEDS seeds."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    x[-4:] = 0.0
    ei = np.stack([rng.integers(0, N - 4, 40), rng.integers(0, N - 4, 40)])
    tree, cycle, seq = jax_structures(ei, N, SEEDS, max_tree_edges=6)
    return x, ei, tree, cycle, seq


X, EI, TREE, CYCLE, SEQ = _batch()
H_PTS = np.asarray(jmm.LorentzM().expmap0(jmm.LorentzM().proju0(
    jnp.asarray(_cot((N, EMB), 13) * 0.5))))
S_PTS = np.asarray(jmm.SphereM().expmap0(jmm.SphereM().proju0(
    jnp.asarray(_cot((N, EMB), 14)))))
E_PTS = _cot((N, EMB), 15)
E_PTS /= np.linalg.norm(E_PTS, axis=1, keepdims=True)
TILED = SEEDS * N


def _tiled(a):
    return np.tile(a, (SEEDS, 1))


def _layer_cases():
    L, S, E = jmm.LorentzM(), jmm.SphereM(), jmm.EuclideanM()
    tL, tS, tE = tmm.LorentzM(), tmm.SphereM(), tmm.EuclideanM()
    return {
        "ccl_lorentz": (jl.ConstCurveLinear(L, EMB, 5), (H_PTS,),
                        tl.ConstCurveLinear(tL, EMB, 5), 0),
        "ccl_sphere_relu": (
            jl.ConstCurveLinear(S, EMB, 5, bias=False, scale_init=3.0,
                                activation=jax.nn.relu), (S_PTS,),
            tl.ConstCurveLinear(tS, EMB, 5, bias=False, scale_init=3.0,
                                activation=torch.relu), 0),
        "agg_lorentz": (jl.ConstCurveAgg(L, EMB), (H_PTS, EI),
                        tl.ConstCurveAgg(tL, EMB), 0),
        "agg_sphere_att": (jl.ConstCurveAgg(S, EMB, use_att=True),
                           (S_PTS, EI),
                           tl.ConstCurveAgg(tS, EMB, use_att=True), 0),
        "agg_lorentz_att": (jl.ConstCurveAgg(L, EMB, use_att=True),
                            (H_PTS, EI),
                            tl.ConstCurveAgg(tL, EMB, use_att=True), 0),
        "euclidean_encoder": (jl.EuclideanEncoder(FEAT, HID, EMB), (X,),
                              tl.EuclideanEncoder(FEAT, HID, EMB), 0),
        "manifold_encoder_h": (jl.ManifoldEncoder(L, FEAT, HID, EMB),
                               (X, EI), tl.ManifoldEncoder(tL, FEAT, HID,
                                                           EMB), 0),
        "manifold_encoder_s": (jl.ManifoldEncoder(S, FEAT, HID, EMB),
                               (X, EI), tl.ManifoldEncoder(tS, FEAT, HID,
                                                           EMB), 0),
        "vq_e": (jv.VectorQuantizeE(EMB, 7, 4, heads=2), (E_PTS,),
                 tv.VectorQuantizeE(EMB, 7, 4, heads=2), "vq"),
        "vq_r_lorentz": (jv.VectorQuantizeR(L, EMB, 7, 4, heads=2),
                         (H_PTS,), tv.VectorQuantizeR(tL, EMB, 7, 4,
                                                      heads=2), "vq"),
        "vq_r_sphere": (jv.VectorQuantizeR(S, EMB, 6, 3, heads=3),
                        (S_PTS,), tv.VectorQuantizeR(tS, EMB, 6, 3,
                                                     heads=3), "vq"),
        "cross_attention": (ja.CrossManifoldAttention(S, L, EMB, HID, EMB),
                            (_tiled(S_PTS), _tiled(H_PTS), _tiled(H_PTS),
                             TREE), ta.CrossManifoldAttention(
                                 tS, tL, EMB, HID, EMB), 0),
        "euclidean_attention": (ja.EuclideanAttention(EMB, HID, EMB),
                                (_tiled(E_PTS),) * 3 + (SEQ,),
                                ta.EuclideanAttention(EMB, HID, EMB), 0),
        "hyp_learner": (ja.HyperbolicStructureLearner(L, S, EMB, HID, EMB),
                        (H_PTS, S_PTS, TREE, SEEDS),
                        ta.HyperbolicStructureLearner(tL, tS, EMB, HID, EMB),
                        0),
        "sph_learner": (ja.SphericalStructureLearner(L, S, EMB, HID, EMB),
                        (H_PTS, S_PTS, CYCLE, SEEDS),
                        ta.SphericalStructureLearner(tL, tS, EMB, HID, EMB),
                        0),
        "euc_learner": (ja.EuclideanStructureLearner(E, EMB, HID, EMB),
                        (E_PTS, SEQ, SEEDS),
                        ta.EuclideanStructureLearner(tE, EMB, HID, EMB), 0),
    }


LAYERS = _layer_cases()


def _j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _tt(a):
    return _t(a) if isinstance(a, np.ndarray) else a


@functools.lru_cache(maxsize=None)
def _jax_layer(name):
    jmod, jin, _, kind = LAYERS[name]
    jin = tuple(_j(a) for a in jin)
    static = tuple(i for i, a in enumerate(jin) if isinstance(a, int))
    dyn = [a for a in jin if not isinstance(a, int)]

    def full(d):
        d = iter(d)
        return tuple(jin[i] if i in static else next(d)
                     for i in range(len(jin)))

    params = jax.jit(lambda d: jmod.init(KEY, *full(d)))(dyn)
    if name.startswith("agg") and "att" in name:
        # move the bias off its saturating 20
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["params"]["att_bias"] = jnp.asarray([0.3])

    def loss(p, d):
        out = jmod.apply(p, *full(d))
        if kind == "vq":
            q, ind, lv, dist = out
            g = _cot(q.shape, 16)
            return jnp.sum(q * g) + 3.0 * lv, (q, ind, lv, dist)
        return jnp.sum(out * _cot(out.shape, 16)), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params, dyn)
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rgt_layer_matches_jax(name):
    _, jin, tmod, kind = LAYERS[name]
    params, want, grads = _jax_layer(name)
    model = load_jax_params(tmod, params)
    out = model(*(_tt(a) for a in jin))
    if kind == "vq":
        q, ind, lv, dist = out
        loss = (q * _t(_cot(tuple(q.shape), 16))).sum() + 3.0 * lv
        for got_, want_ in ((q, want[0]), (lv, want[2]), (dist, want[3])):
            _check(got_, want_, TOL)
        np.testing.assert_array_equal(ind.numpy(), want[1])
    else:
        loss = (out * _t(_cot(tuple(out.shape), 16))).sum()
        _check(out, want, TOL)
    if loss.requires_grad:  # ConstCurveAgg without attention has none
        loss.backward()
    # the query map's gradient is 0 by the math (see _Q_LIN below)
    zero = {"cross_attention": ("q_lin/weight/kernel",),
            "hyp_learner": ("tree_agg/q_lin/weight/kernel",)}.get(name, ())
    _check_grads(model, grads, GTOL, zero=zero)


def test_ccl_dropout_needs_the_jax_flag():
    """Dropout acts only when a call is not ``deterministic``, as in JAX:
    the module's training mode alone leaves it off."""
    layer = tl.ConstCurveLinear(tmm.LorentzM(), EMB, 5, dropout=0.5)
    x = _t(H_PTS)
    with torch.no_grad():
        a = layer.train()(x)
        b = layer.eval()(x)
        c = layer(x, deterministic=False,
                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the whole model ------------------------------------------------------

RGT_KW = dict(hidden_dim=HID, embed_dim=EMB, n_layers=2, codebook_size=6,
              codebook_dim=4, codebook_heads=2)


@functools.lru_cache(maxsize=None)
def _jax_rgt():
    model = JaxRGT(in_dim=FEAT, **RGT_KW)
    args = (jnp.asarray(X), jnp.asarray(EI), jnp.asarray(TREE),
            jnp.asarray(CYCLE), jnp.asarray(SEQ))
    params = jax.jit(lambda: model.init(KEY, *args, SEEDS,
                                        method=JaxRGT.train_loss))()

    def loss(p):
        def both(m, *a):  # one forward: train_loss's, and its outputs
            out = m(*a)
            return m.loss(out), out

        (value, fused), out = model.apply(p, *args, SEEDS, method=both)
        return value, (fused, out)

    (value, (fused, out)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    return (_np_tree(params), float(value), np.asarray(fused),
            jax.tree_util.tree_map(np.asarray, out), grads)


def _rgt_inputs():
    return tuple(_t(a) for a in (X, EI, TREE, CYCLE, SEQ)) + (SEEDS,)


# the tree learners' query maps: a query enters its edges' scores as one
# constant a source, which the source's softmax cancels wherever its
# scores share the LeakyReLU's side, so their gradients are 0 by the math
# (both packages give rounding noise of ~1e-10)
_Q_LIN = tuple(f"block_{i}/hyp_learner/tree_agg/q_lin/weight/kernel"
               for i in range(2))


def test_rgt_train_loss_and_grads_match_jax():
    """The loss, the fused embedding and every parameter gradient. The
    padded (zero-token) rows are normalised at their epsilon, which
    scales some gradients up to ~1e9 in both packages."""
    params, value, fused, out, grads = _jax_rgt()
    model = load_jax_params(RGTModel(FEAT, **RGT_KW), params)
    loss, got_fused = model.train_loss(*_rgt_inputs())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), value, rtol=1e-5)
    _check(got_fused, fused, TOL)
    _check_grads(model, grads, GTOL, zero=_Q_LIN)
    got = dict(zip(("/".join(k) for k in _layout(model)),
                   (p for p, _ in _layout(model).values())))
    want = dict(_flat(grads["params"]))
    for name in _Q_LIN:
        assert float(got[name].grad.abs().max()) < 1e-8
        assert float(np.abs(want[name]).max()) < 1e-8


def test_rgt_forward_matches_jax():
    params, _, _, want, _ = _jax_rgt()
    model = load_jax_params(RGTModel(FEAT, **RGT_KW), params)
    with torch.no_grad():
        got = model(*_rgt_inputs())
    for key in ("x_E", "x_H", "x_S", "q_E", "q_H", "q_S", "commit_loss"):
        _check(got[key], want[key], TOL)
    for a, b in zip(got["indices"], want["indices"]):
        np.testing.assert_array_equal(a.numpy(), b)
    # rgt_loss reads the batch by JAX's keys
    batch = dict(zip(("tokens", "edge_index", "tree_edge_index",
                      "cycle_edge_index", "seq_edge_index", "num_seeds"),
                     _rgt_inputs()))
    with torch.no_grad():
        loss, _ = rgt_loss(model, batch)
    np.testing.assert_allclose(float(loss), _jax_rgt()[1], rtol=1e-5)


def test_rgt_cl_loss_matches_jax():
    a, b = _cot((7, 5), 1), _cot((7, 5), 2)
    want, vjp = jax.vjp(jax_cl_loss, jnp.asarray(a), jnp.asarray(b))
    wa, wb = vjp(jnp.float32(1.0))
    ta_, tb_ = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = rgt_cl_loss(ta_, tb_)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    _check(ta_.grad, wa, GTOL)
    _check(tb_.grad, wb, GTOL)


def test_rgt_nan_tokens_and_own_init():
    """The port's own init (the token map lazy): a finite loss that
    backpropagates; a NaN token row is zeroed by the one `nan_to_num`.
    The token map's weight gradient takes the NaN feature times 0 in its
    column, as in JAX; every other gradient is finite."""
    torch.manual_seed(0)
    model = RGTModel(None, **RGT_KW)
    inputs = list(_rgt_inputs())
    inputs[0] = inputs[0].clone()
    inputs[0][-1, 0] = float("nan")
    loss, fused = model.train_loss(*inputs)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(fused).all()
    w = model.token_proj.weight.grad
    assert torch.isnan(w[:, 0]).all() and torch.isfinite(w[:, 1:]).all()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.grad is not None and p is not model.token_proj.weight)
