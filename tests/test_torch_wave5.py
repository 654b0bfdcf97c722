"""The port's wave-5 models (`models/wave5_models.py`: SIGN, the
UniFews-pruned GCN, HardGAT, AdaGAD, Sp2GCL) and `utils/pruning.py`
against the JAX package's.

Each model is built in JAX with its own ``init``, carried across with
`load_jax_params`, and fed the same numpy inputs (from a seed), dropout
off. Outputs and the gradients of a loss of them in every parameter are
held at 1e-5 of max |out| (of each parameter's max |grad|), float32.
HardGAT's top-k selection is held edge for edge on a graph with tied
scores, and UniFews's pruned edge set on weights away from its
threshold. Each JAX reference is compiled once for the module (cached).
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
import gammagl_tpu.models.wave5_models as jw5  # noqa: E402
import gammagl_tpu.utils.pruning as jpr  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from gammagl_tpu.utils import calc_gcn_norm as jax_gcn_norm  # noqa: E402
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

import gammagl_tpu_torch.models as tm  # noqa: E402
import gammagl_tpu_torch.utils.pruning as tpr  # noqa: E402
from gammagl_tpu_torch.utils import calc_gcn_norm, load_jax_params  # noqa

TOL = 1e-5
N, E, FEAT, HID = 30, 90, 12, 16
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


def _graph(seed=0):
    """x (N, FEAT) with rows 0-3 equal and rows 4-5 equal (their source
    scores tie exactly in either package), edges with self-loops: node 1
    gets six in-edges from the tied sources, node 2 a single one (it loses
    every edge to the peeling before round k), and nodes N-4.. only their
    self-loops."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    x[1:4] = x[0]
    x[5] = x[4]
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N - 4, E)])
    tied = np.array([[0, 1, 2, 3, 4, 5, 7], [1, 1, 1, 1, 1, 1, 2]])
    ei = np.concatenate([ei[:, (ei[1] != 1) & (ei[1] != 2)], tied], 1)
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


def _edge_thr():
    """A threshold halfway between two neighbouring values of the GCN
    norm on EI near its median: no weight lies within rounding of it."""
    w = np.unique(np.asarray(jax_gcn_norm(jnp.asarray(EI), N), np.float64))
    i = len(w) // 2
    return float((w[i] + w[i + 1]) / 2)


THR = _edge_thr()


def _cases():
    """name -> (jax model, jax inputs, port model, port inputs, loss of
    the output in JAX, the same in torch)."""
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    tx, tei = _t(X), _t(EI)
    xs = [_cot((N, FEAT), s) for s in (1, 2, 3)]
    neg = np.stack([np.arange(N), (np.arange(N) * 7 + 3) % N])
    eig = _cot((N, 6), 4)
    return {
        "sign": (jm.SIGNModel(4, HID, K=2, drop_rate=0.0),
                 ([jnp.asarray(a) for a in xs],),
                 tm.SIGNModel(4, HID, K=2, drop_rate=0.0),
                 ([_t(a) for a in xs],), *_emb((N, 4))),
        "unifews": (jm.GCNUniFews(4, HID, edge_thr=THR), (x, ei),
                    tm.GCNUniFews(4, HID, edge_thr=THR), (tx, tei),
                    *_emb((N, 4))),
        "unifews_weighted": (
            jm.GCNUniFews(4, HID, edge_thr=0.5),
            (x, ei, jnp.asarray(np.linspace(-1, 1.1, EI.shape[1]),
                                jnp.float32)),
            tm.GCNUniFews(4, HID, edge_thr=0.5),
            (tx, tei, _t(np.linspace(-1, 1.1, EI.shape[1]).astype(
                np.float32))), *_emb((N, 4))),
        "hardgat": (jm.HardGATModel(4, 3, heads=2, k=2), (x, ei),
                    tm.HardGATModel(4, 3, heads=2, k=2), (tx, tei),
                    *_emb((N, 3))),
        "hardgat_k3": (jm.HardGATConv(5, heads=3, k=3), (x, ei),
                       tm.HardGATConv(FEAT, 5, heads=3, k=3), (tx, tei),
                       *_emb((N, 15))),
        "adagad_score": (jm.AdaGADModel(HID, 8), (x, ei),
                         tm.AdaGADModel(HID, 8), (tx, tei), *_emb((N,))),
        "adagad_loss": (jm.AdaGADModel(HID, 8), (x, ei, neg),
                        tm.AdaGADModel(HID, 8), (tx, tei, _t(neg)), *IDENT),
        "sp2gcl": (jm.Sp2GCLModel(HID), (x, ei, jnp.asarray(eig)),
                   tm.Sp2GCLModel(HID), (tx, tei, _t(eig)), *IDENT),
    }


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's init tree, its output and the gradients of its loss,
    each compiled once."""
    jmod, jin, _, _, jloss, _ = CASES[name]
    params = jax.jit(jmod.init)({"params": KEY, "dropout": KEY}, *jin)

    def loss(p):
        out = jmod.apply(p, *jin)
        return jloss(out), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return _np_tree(params), np.asarray(out), grads


def _port(name):
    _, _, tmod, tin, _, tloss = CASES[name]
    params, _, _ = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    model.zero_grad(set_to_none=True)
    out = model(*tin)
    tloss(out).backward()
    return model, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_output_and_grads_match_jax(name):
    model, out = _port(name)
    _, want, grads = _jax_case(name)
    _check(out, want, TOL)
    _check_grads(model, grads, TOL)


def _jax_keep(jconv_params, k, heads, out_channels):
    """The JAX HardGATConv's kept edges, read from the scores it hands
    `segment_softmax` (the dropped ones are -1e9)."""
    seen = []
    real = jw5.segment_softmax

    def record(e, *args):
        seen.append(np.asarray(e))
        return real(e, *args)

    jw5.segment_softmax = record
    try:
        jm.HardGATConv(out_channels, heads=heads, k=k).apply(
            jconv_params, jnp.asarray(X), jnp.asarray(EI))
    finally:
        jw5.segment_softmax = real
    return (seen[0] > -1e8).all(axis=1)


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_hardgat_keeps_jax_edges_on_tied_scores(k):
    """The kept set, edge for edge: ties at the threshold are all kept in
    both packages (node 1's six tied sources), and a destination whose
    edges are all peeled before round k keeps only those of score >= 0,
    as in JAX (its segment max of -inf reads 0)."""
    jconv = jm.HardGATConv(5, heads=2, k=k)
    params = jax.jit(jconv.init)(KEY, jnp.asarray(X), jnp.asarray(EI))
    want = _jax_keep(params, k, 2, 5)
    conv = load_jax_params(tm.HardGATConv(FEAT, 5, heads=2, k=k),
                           _np_tree(params))
    got = conv.keep_mask(_t(X), _t(EI)).numpy()
    np.testing.assert_array_equal(got, want)
    scores = X @ np.asarray(params["params"]["Dense_0"]["kernel"])[:, 0]
    s_e = scores[EI[0]]
    on1 = EI[1] == 1
    assert len(np.unique(s_e[on1])) < on1.sum()  # tied scores on node 1
    on2 = EI[1] == 2
    if k > len(np.unique(s_e[on2])):  # node 2: all peeled before round k
        np.testing.assert_array_equal(got[on2], s_e[on2] >= 0)
        assert not got[on2].all()


def test_hardgat_keep_is_the_peeling_rule():
    """The kept set against the rule in numpy: an edge is kept when its
    score reaches the k-th distinct peel of its destination (ties peel
    together), or, for a destination with fewer peels, when it is >= 0."""
    k = 2
    conv = tm.HardGATConv(FEAT, 5, heads=2, k=k)
    got = conv.keep_mask(_t(X), _t(EI)).numpy()
    with torch.no_grad():
        s = (conv.proj(_t(X))[:, 0]).numpy()[EI[0]]
    want = np.zeros_like(got)
    for d in range(N):
        on = EI[1] == d
        levels = np.sort(np.unique(s[on]))[::-1]
        thr = levels[k - 1] if len(levels) >= k else 0.0
        want[on] = s[on] >= thr
    np.testing.assert_array_equal(got, want)


def test_unifews_prunes_jax_edge_set():
    """The weights below the threshold are exact zeros in both packages,
    the same edges, with a margin from the threshold on either side."""
    jw = np.asarray(jax_gcn_norm(jnp.asarray(EI), N))
    tw = calc_gcn_norm(_t(EI), N).numpy()
    assert np.abs(jw - THR).min() > 1e-4
    jp = np.asarray(jpr.prune_edges_by_weight(jnp.asarray(jw), THR))
    tp = tpr.prune_edges_by_weight(_t(tw), THR).numpy()
    np.testing.assert_array_equal(tp == 0, jp == 0)
    assert 0 < (tp == 0).sum() < len(tp)
    np.testing.assert_allclose(tp, jp, rtol=1e-6)


def _jax_tree():
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.GCNUniFews(4, HID).init)(
            KEY, jnp.asarray(X), jnp.asarray(EI)))["params"]


def _torch_tree(tree):
    return {k: (_torch_tree(v) if isinstance(v, dict) else _t(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("thr", [0.0, 0.05, 0.2, 10.0])
def test_pruning_helpers_match_jax(thr):
    """`threshold_prune`, `prune_params`, `rewind`, `sparsity` and
    `GCNUniFews.apply_weight_masks` on one tree, bitwise."""
    tree = _jax_tree()
    init = jax.tree_util.tree_map(lambda a: a * 0.5 + 1.0, tree)
    jp, jmask = jpr.prune_params(tree, thr)
    tp, tmask = tpr.prune_params(_torch_tree(tree), thr)

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for key in a:
                same(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    same(jp, tp)
    same(jmask, tmask)
    same(jpr.rewind(jp, init, jmask), tpr.rewind(tp, _torch_tree(init),
                                                  tmask))
    assert tpr.sparsity(tmask) == jpr.sparsity(jmask)
    same(jm.GCNUniFews.apply_weight_masks(tree, jmask),
         tm.GCNUniFews.apply_weight_masks(_torch_tree(tree), tmask))
    a = _cot((7, 5), 9)
    for j, t in zip(jpr.threshold_prune(jnp.asarray(a), thr),
                    tpr.threshold_prune(_t(a), thr)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_pruned_state_dict_loads_into_the_model():
    """`prune_params` on a module's ``state_dict()``: the masked tree loads
    back, and its zeros are the masks' zeros."""
    model = tm.GCNUniFews(4, HID, in_channels=FEAT)
    pruned, masks = tpr.prune_params(model.state_dict(), 0.2)
    model.load_state_dict(pruned)
    w = model.conv0.linear.weight.detach()
    assert torch.equal(w == 0, ~masks["conv0.linear.weight"])
    assert 0 < tpr.sparsity(masks) < 1


def test_sign_dropout_draws_from_the_generator():
    """Training mode: one generator state gives one output, which differs
    from the eval forward; the model's own init is lazy."""
    model = tm.SIGNModel(3, HID, K=2, drop_rate=0.5)
    xs = [_t(_cot((N, FEAT), s)) for s in (1, 2, 3)]
    model.train()
    outs = [model(xs, torch.Generator().manual_seed(1)) for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], model.eval()(xs))


def test_models_own_init_runs_lazy():
    """The port's own init (lazy first maps): finite outputs and losses
    that backpropagate."""
    tx, tei = _t(X), _t(EI)
    neg = _t(np.stack([np.arange(N), np.arange(N)[::-1].copy()]))
    for model, inputs in (
            (tm.GCNUniFews(3, HID, edge_thr=0.1), (tx, tei)),
            (tm.HardGATModel(4, 3, heads=2, k=3), (tx, tei)),
            (tm.AdaGADModel(HID, 8), (tx, tei, neg)),
            (tm.Sp2GCLModel(HID), (tx, tei, _t(_cot((N, 5)))))):
        out = model(*inputs)
        out.sum().backward()
        assert torch.isfinite(out).all()
    assert tm.AdaGADModel(HID, 8)(tx, tei).shape == (N,)


def test_c33_unifews_norms_at_the_threshold_follow_float32_rounding():
    """ROADMAP C33. An edge between in-degrees a and b has the GCN norm
    (a b)^-1/2, exactly the twin's threshold 0.05 where a b = 400. In
    float32 it lands a bit above or below, and `prune_edges_by_weight`
    keeps or drops it by that bit: on the CPU the port and JAX round
    alike (kept at 1 x 400, 4 x 100, 16 x 25; dropped at 5 x 80,
    20 x 20), edge for edge; the card may round apart (phase 36 counts
    it)."""
    pairs = [(1, 400), (2, 200), (4, 100), (5, 80), (8, 50), (10, 40),
             (16, 25), (20, 20)]
    hub, src, dst, probe = 0, [], [], []
    for i, (a, b) in enumerate(pairs):
        u, v = 1 + 2 * i, 2 + 2 * i
        src += [hub] * a + [u] + [hub] * (b - 1)
        dst += [u] * a + [v] + [v] * (b - 1)
        probe.append(len(src) - b)  # the edge u -> v
    ei = np.array([src, dst])
    n = 1 + 2 * len(pairs)
    want = np.asarray(jpr.prune_edges_by_weight(
        jax_gcn_norm(jnp.asarray(ei), n), 0.05))
    got = tpr.prune_edges_by_weight(calc_gcn_norm(_t(ei), n), 0.05).numpy()
    np.testing.assert_array_equal(got, want)
    kept = got[probe] != 0
    np.testing.assert_array_equal(kept, [a * b == 400 and (a, b) not in (
        (5, 80), (20, 20)) for a, b in pairs])
