"""The port's wave-8 models (`models/wave8_models.py`: GEN's EM
estimation, FatraGNN, its feature editor and structure edit) and
`utils/misc.py` / `utils/unifews_log.py` against the JAX package's.

FatraGNN is built in JAX with its own ``init``, carried across with
`load_jax_params`, and every branch of its ``flag`` held at 1e-5 of max
|out| with the gradients of a loss of it in every parameter. The host
code (GEN's EM, `modify_structure`, the splits, the conversions, the
loggers) gives JAX's values bitwise, homophily at float32 rounding.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.models as jm  # noqa: E402
import gammagl_tpu.utils.misc as jmisc  # noqa: E402
import gammagl_tpu.utils.unifews_log as jlog  # noqa: E402
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

import gammagl_tpu_torch.models as tm  # noqa: E402
import gammagl_tpu_torch.utils.misc as tmisc  # noqa: E402
import gammagl_tpu_torch.utils.unifews_log as tlog  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

TOL = 1e-5
N, E, FEAT = 40, 160, 8
KEY = jax.random.PRNGKey(3)


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


def _graph(seed=0, n=N, e=E, c=3, p_same=0.7):
    """Labels in c classes, edges that join one label with probability
    about p_same, the last 4 nodes without in-edges, features."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 4, e)
    same = rng.random(e) < p_same
    pick = np.array([rng.choice(np.nonzero(y[:n - 4] == y[s])[0])
                     if (y[:n - 4] == y[s]).any() else d
                     for s, d in zip(src, dst)])
    dst = np.where(same, pick, dst)
    x = rng.normal(size=(n, FEAT)).astype(np.float32)
    return x, np.stack([src, dst]).astype(np.int64), y


X, EI, Y = _graph()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("method", ["edge", "node"])
@pytest.mark.parametrize("p_same", [0.2, 0.8])
def test_homophily_matches_jax(method, p_same):
    _, ei, y = _graph(1, p_same=p_same)
    want = jmisc.homophily(jnp.asarray(ei), jnp.asarray(y), method)
    for a, b in ((ei, y), (_t(ei), _t(y))):
        np.testing.assert_allclose(tmisc.homophily(a, b, method), want,
                                   rtol=1e-6)
    with pytest.raises(ValueError):
        tmisc.homophily(ei, y, "graph")


@pytest.mark.parametrize("norm", [None, "sym", "rw"])
@pytest.mark.parametrize("weighted", [False, True])
def test_get_laplacian_matches_jax(norm, weighted):
    w = np.linspace(0.5, 2.0, E).astype(np.float32) if weighted else None
    jei, jw = jmisc.get_laplacian(jnp.asarray(EI), N,
                                  None if w is None else jnp.asarray(w),
                                  norm)
    tei, tw = tmisc.get_laplacian(_t(EI), N, None if w is None else _t(w),
                                  norm)
    np.testing.assert_array_equal(tei.numpy(), np.asarray(jei))
    assert tw.dtype == torch.float32
    _check(tw, jw, 1e-6)


def test_scipy_conversions_match_jax():
    w = np.arange(E, dtype=np.float32)
    for args in ((EI,), (EI, w), (EI, None, N + 3)):
        a = tmisc.to_scipy_sparse_matrix(*args)
        b = jmisc.to_scipy_sparse_matrix(*args)
        assert a.shape == b.shape
        assert (a != b).nnz == 0
        ta = tmisc.to_scipy_sparse_matrix(*(_t(v) if v is not None
                                            and not isinstance(v, int)
                                            else v for v in args))
        assert (ta != b).nnz == 0
    mat = sp.random(12, 12, density=0.3, random_state=1, format="csr")
    for got, want in zip(tmisc.from_scipy_sparse_matrix(mat),
                         jmisc.from_scipy_sparse_matrix(mat)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("per_class", [None, 3])
def test_train_val_test_split_is_jax(per_class):
    kw = dict(train_per_class=per_class, labels=Y, train_ratio=0.3,
              val_ratio=0.2)
    for got, want in zip(
            tmisc.get_train_val_test_split(N, rng=np.random.default_rng(4),
                                           **kw),
            jmisc.get_train_val_test_split(N, rng=np.random.default_rng(4),
                                           **kw)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tmisc.get_train_val_test_split(N),
                         jmisc.get_train_val_test_split(N)):
        np.testing.assert_array_equal(got, want)


# -- GEN -----------------------------------------------------------------

def _knn_adj(x, k=3):
    sim = x @ x.T
    np.fill_diagonal(sim, -np.inf)
    a = np.zeros((len(x), len(x)), np.int64)
    a[np.repeat(np.arange(len(x)), k),
      np.argsort(-sim, 1)[:, :k].reshape(-1)] = 1
    return a


@pytest.mark.parametrize("p_same", [0.0, 0.95])
def test_gen_em_is_jax(p_same):
    """Two observations (the graph and a kNN graph), predictions with
    errors, the EM from one seed: alpha, beta, O, Q and the iteration
    count bitwise; above 0.5 node homophily both add the graph to Q."""
    x, ei, y = _graph(2, p_same=p_same)
    train = np.arange(0, N, 3)
    obs = [np.zeros((N, N), np.int64), _knn_adj(x)]
    obs[0][ei[0], ei[1]] = 1
    pred = np.where(np.arange(N) % 5 == 0, (y + 1) % 3, y)
    ests = [tm.GEstimationN(N, 3, ei, y, train),
            jm.GEstimationN(N, 3, ei, y, train)]
    for est in ests:
        est.reset_obs()
        for o in obs:
            est.update_obs(o)
    got = ests[0].EM(pred, seed=1, max_iters=20)
    want = ests[1].EM(pred, seed=1, max_iters=20)
    assert abs(ests[0].homophily - ests[1].homophily) < 1e-6
    assert (ests[0].homophily > 0.5) == (p_same > 0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[4] > 1


def test_gen_takes_tensors():
    x, ei, y = _graph(2)
    est = tm.GEstimationN(N, 3, _t(ei), _t(y), _t(np.arange(5)))
    est.reset_obs()
    est.update_obs(_t(_knn_adj(x)))
    ref = jm.GEstimationN(N, 3, ei, y, np.arange(5))
    ref.reset_obs()
    ref.update_obs(_knn_adj(x))
    for a, b in zip(est.em(_t(y), max_iters=5), ref.em(y, max_iters=5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("drop", [0.0, 0.6, 1.0])
def test_modify_structure_is_jax(align, drop):
    sens = (Y == 1).astype(np.int64)
    rng = np.random.default_rng(9)
    a2 = np.stack([rng.integers(0, N, 300), rng.integers(0, N, 300)])
    want = jm.modify_structure(EI, a2, sens, drop=drop, align=align)
    got = tm.modify_structure(EI, a2, sens, drop=drop, align=align)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(
        tm.modify_structure(_t(EI), _t(a2), _t(sens), drop=drop,
                            align=align), want)


# -- FatraGNN -------------------------------------------------------------

def _fatra_inputs():
    """EI with self-loops and its edit: every node keeps an in-edge in
    both (a node without one has a zero row, where JAX's unit rows have a
    NaN gradient: ROADMAP C32, the test below)."""
    loops = np.concatenate([EI, np.stack([np.arange(N)] * 2)], 1)
    sens = (Y == 1).astype(np.int64)
    return loops, jm.modify_structure(loops, loops, sens, drop=0.6)


EI_L, EI2 = _fatra_inputs()


@pytest.fixture(scope="module")
def fatra_jax():
    jmod = jm.FatraGNNModel(FEAT, 16)
    x, ei = jnp.asarray(X), jnp.asarray(EI_L)
    params = jax.jit(lambda k: jmod.init(k, x, ei,
                                         method=jm.FatraGNNModel.init_all))(
        KEY)
    g = np.random.default_rng(7).normal(size=(N, 16)).astype(np.float32)
    out = {}
    for flag in (0, 1, 2, 3, 4, 5):
        def f(p, flag=flag):
            o = jmod.apply(p, x, ei, flag, edge_index2=jnp.asarray(EI2))
            if flag == 5:
                return jnp.sum(o["h1"] * g) + 2 * jnp.sum(o["h2"] * g), o
            return jnp.sum(o * jnp.arange(N)[:, None]), o
        out[flag] = jax.jit(jax.grad(f, has_aux=True))(params)
    return _np_tree(params), out, g


@pytest.mark.parametrize("flag", [0, 1, 2, 3, 4, 5])
def test_fatragnn_flags_match_jax(flag, fatra_jax):
    params, out, g = fatra_jax
    grads, want = out[flag]
    model = load_jax_params(tm.FatraGNNModel(FEAT, 16), params)
    got = model(_t(X), _t(EI_L), flag, edge_index2=_t(EI2))
    if flag == 5:
        loss = (got["h1"] * _t(g)).sum() + 2 * (got["h2"] * _t(g)).sum()
        _check(got["h1"], want["h1"], TOL)
        _check(got["h2"], want["h2"], TOL)
    else:
        loss = (got * torch.arange(N)[:, None]).sum()
        _check(got, want, TOL)
    loss.backward()
    _check_grads(model, grads, TOL)
    with pytest.raises(ValueError):
        model(_t(X), _t(EI), 6)


def test_c32_fatragnn_unit_rows_at_a_zero_row(fatra_jax):
    """ROADMAP C32, C28's cause in FatraGNN. Without self-loops the last 4
    nodes have no in-edge: their encoder rows are the bias, 0 at init, and
    flag 5 scales them to unit rows by ``h / (norm(h) + 1e-12)``. JAX's
    ``jnp.linalg.norm`` has a NaN derivative at 0, so the gradient that
    reaches those rows (the encoder's bias) is NaN in JAX; the port's
    ``vector_norm`` has derivative 0 there, so its bias gradient is
    finite. The outputs (rows of 0) and the kernel's gradient, which
    those rows do not reach, are JAX's."""
    params, _, _ = fatra_jax
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    jmod = jm.FatraGNNModel(FEAT, 16)
    jgrads = jax.grad(lambda p: jnp.sum(jmod.apply(
        p, x, ei, 5, edge_index2=ei)["h1"]))(params)["params"]["encoder"]
    assert np.isnan(np.asarray(jgrads["bias"])).all()
    model = load_jax_params(tm.FatraGNNModel(FEAT, 16), params)
    out = model(_t(X), _t(EI), 5, edge_index2=_t(EI))
    want = jmod.apply(params, x, ei, 5, edge_index2=ei)
    _check(out["h1"], want["h1"], TOL)
    assert float(out["h1"][-4:].detach().abs().max()) == 0.0
    out["h1"].sum().backward()
    assert torch.isfinite(model.encoder.bias.grad).all()
    _check(model.encoder.linear.weight.grad.T, jgrads["Dense_0"]["kernel"],
           TOL)


# -- the UniFews loggers ----------------------------------------------------

def test_unifews_loggers_match_jax(tmp_path, capsys):
    """The CSV row and header, the run directory's files, best-score
    tracking with early stop, checkpoints of a state dict, layer counts,
    streaming F1 and the stopwatch, as the JAX package's."""
    args = ("cora", "gcn", 3, 0.05, 0.01, 0.8125, 12, 40, 1.5, 2.0, 0.25,
            0.5, 1.0, 0.75)
    lg = tlog.UniFewsLogger("cora", "gcn", flag_run="r1",
                            dir_base=str(tmp_path / "t"))
    jl = jlog.UniFewsLogger("cora", "gcn", flag_run="r1",
                            dir_base=str(tmp_path / "j"))
    assert lg.str_csv(*args) == jl.str_csv(*args)
    lg.print_header(*lg.str_csv(*args))
    lg.save_opt({"lr": 0.01})
    assert lg.load_opt() == {"lr": 0.01}
    with open(lg.file_log) as f:
        assert f.read().splitlines()[:2] == list(lg.str_csv(*args))
    ml = tlog.ModelLogger(lg, patience=2, cmp=">")
    model = torch.nn.Linear(3, 2)
    ml.register(model.state_dict())
    scores = [0.5, 0.7, 0.6, 0.65, 0.69]
    best = [ml.save_best(s, e, params=model.state_dict())
            for e, s in enumerate(scores)]
    jml = jlog.ModelLogger(jl, patience=2, cmp=">")
    assert best == [jml.is_best(s, e) for e, s in enumerate(scores)]
    assert ml.best_epoch == 1 and ml.is_early_stop(4) and not \
        ml.is_early_stop(3)
    loaded = ml.load("best")
    assert torch.equal(loaded["weight"], model.weight)
    ml.save_epoch(4, period=2)
    assert osp.exists(lg.path_join("model_epoch_4.pkl"))
    counts = tlog.LayerNumLogger("conv0")
    counts.numel_before, counts.numel_after = 8, 6
    assert repr(counts) == "6/8(75.00%)" and counts.ratio == 0.75
    rng = np.random.default_rng(3)
    yt, yp = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    f1s = []
    for cls in (tlog.F1Calculator, jlog.F1Calculator):
        f1 = cls(4)
        f1.update(yt[:20], yp[:20])
        f1.update(_t(yt[20:]).numpy(), yp[20:])
        f1s.append((f1.compute("micro"), f1.compute("macro")))
    assert f1s[0] == f1s[1]
    sw = tlog.Stopwatch()
    with sw:
        pass
    first = sw.elapsed
    assert first >= 0 and sw.lap() == first
    sw.start()
    assert sw.lap() >= first
    assert sw.pause() >= first
    capsys.readouterr()
