"""The port's wave-7 convs and models (`layers/conv/wave7_convs.py`:
DHN, HEAT, CoED; `models/wave7_models.py`: their models, the vector
quantisers and NodeID, RK4 and GNRF, GRACE-POT and GRACE-Spco) against
the JAX package's.

Each module is built in JAX with its own ``init``, carried across with
`load_jax_params` (NodeID's codebooks with JAX's ``vq_stats``), and fed
the same numpy inputs (from a seed), dropout off. Outputs and the
gradients of a loss of them in every parameter are held at 1e-5 of max
|out| (of each parameter's max |grad|), float32; the quantisers' code ids
exactly and their running statistics after a training step at 1e-5, with
and without dead codes; GNRF's whole RK4 integration at 1e-5 of max
|out|. Each JAX reference is compiled once for the module (cached).
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
from gammagl_tpu.layers.conv import wave7_convs as jc  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _flat, _np_tree)

import gammagl_tpu_torch.models as tm  # noqa: E402
from gammagl_tpu_torch.layers.conv import wave7_convs as tc  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

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
    """x (N, FEAT), edges with self-loops; nodes N-4.. have only their
    self-loops as in-edges, and node 0 sends no edge but its self-loop
    (an isolated source: HEAT and GNRF group by source)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    ei = np.stack([rng.integers(1, N, E), rng.integers(0, N - 4, E)])
    ei, _ = jax_add_self_loops(ei, num_nodes=N)
    return x, np.asarray(ei, np.int64)


X, EI = _graph()
NE = EI.shape[1]
EI_RING = np.concatenate([EI, [np.arange(N), (np.arange(N) + 1) % N]], 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _emb(shape, seed=7):
    g = _cot(shape, seed)
    return (lambda out: jnp.sum(out * g), lambda out: (out * _t(g)).sum())


def _tuple_loss(*shapes):
    """sum_i sum(out_i * g_i) over a tuple output."""
    gs = [_cot(s, 10 + i) for i, s in enumerate(shapes)]
    return (lambda out: sum(jnp.sum(o * g) for o, g in zip(out, gs)),
            lambda out: sum((o * _t(g)).sum() for o, g in zip(out, gs)))


IDENT = (lambda out: out, lambda out: out)


def _dhn_block(seed, K=3, Fd=4, B=10):
    width = Fd + K * Fd + K * K * Fd
    return _cot((B, width), seed), K, Fd


def _case(jmod, jin, tmod, tin, loss, method=None, tcall=None, zero=()):
    return {"j": jmod, "jin": jin, "t": tmod, "tin": tin, "loss": loss,
            "method": method, "tcall": tcall, "zero": zero}


def _cases():
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    tx, tei = _t(X), _t(EI)
    rng = np.random.default_rng(5)
    attr = _cot((NE, 5), 1)
    etype = np.eye(4, dtype=np.float32)[rng.integers(0, 4, NE)]
    w = (rng.random(NE) * 1.5).astype(np.float32)
    w_rev = (rng.random(NE) + 0.5).astype(np.float32)
    hist = _cot((N, 5, 4), 2)
    n1, K, Fd = _dhn_block(3)
    n2, _, _ = _dhn_block(4)
    x2 = (X * (rng.random((1, FEAT)) > 0.3)).astype(np.float32)
    m1 = (rng.random(NE) > 0.2).astype(np.float32)
    m2 = (rng.random(NE) > 0.4).astype(np.float32)
    m1[-N:] = m2[-N:] = 1.0  # every node keeps its self-loop
    two = (x, ei, jnp.asarray(m1), jnp.asarray(x2), ei, jnp.asarray(m2))
    ttwo = (tx, tei, _t(m1), _t(x2), tei, _t(m2))
    heat_kw = dict(node_emb_size=8, edge_attr_emb_size=6,
                   edge_type_emb_size=5, out_channels=7, heads=3)
    return {
        "dhn_conv": _case(jc.DHNConv(Fd, K, 8), (jnp.asarray(n1),),
                          tc.DHNConv(Fd, K, 8), (_t(n1),), _emb((10, 8))),
        "dhn": _case(jm.DHNModel(Fd, K, 8), (jnp.asarray(n1),
                                             jnp.asarray(n2)),
                     tm.DHNModel(Fd, K, 8), (_t(n1), _t(n2)),
                     _emb((10, 1))),
        "heat_conv": _case(jc.HEATConv(**heat_kw),
                           (x, ei, jnp.asarray(attr), jnp.asarray(etype)),
                           tc.HEATConv(**heat_kw),
                           (tx, tei, _t(attr), _t(etype)), _emb((N, 21))),
        "heat_conv_mean": _case(
            jc.HEATConv(concat=False, **heat_kw),
            (x, ei, jnp.asarray(attr), jnp.asarray(etype)),
            tc.HEATConv(concat=False, **heat_kw),
            (tx, tei, _t(attr), _t(etype)), _emb((N, 7))),
        "heat": _case(jm.HEATModel(8, 7, 6, 8, 6, 5, heads=2,
                                   dropout_rate=0.0),
                      (jnp.asarray(hist), ei, jnp.asarray(attr),
                       jnp.asarray(etype)),
                      tm.HEATModel(8, 7, 6, 8, 6, 5, heads=2,
                                   dropout_rate=0.0),
                      (_t(hist), tei, _t(attr), _t(etype)), _emb((N, 12))),
        "coed_conv": _case(jc.CoEDConv(HID), (x, ei, (jnp.asarray(w),
                                                      jnp.asarray(w_rev))),
                           tc.CoEDConv(None, HID),
                           (tx, tei, (_t(w), _t(w_rev))),
                           _tuple_loss((N, HID), (N, HID), (N, HID))),
        "coed_conv_one_weight": _case(
            jc.CoEDConv(HID, self_feature_transform=False, add_bias=False),
            (x, ei, jnp.asarray(w)),
            tc.CoEDConv(None, HID, self_feature_transform=False,
                        add_bias=False), (tx, tei, _t(w)),
            _tuple_loss((N, HID), (N, HID))),
        "coed_jk_cat": _case(jm.CoEDModel(4, HID, alpha=0.3,
                                          jumping_knowledge="cat",
                                          drop_rate=0.0), (x, ei),
                             tm.CoEDModel(4, HID, alpha=0.3,
                                          jumping_knowledge="cat",
                                          drop_rate=0.0), (tx, tei),
                             _emb((N, 4))),
        "coed_self_norm_att": _case(
            jm.CoEDModel(4, HID, num_layers=3, alpha=0.6, normalize=True,
                         self_feature_transform=True,
                         jumping_knowledge="att", drop_rate=0.0),
            (x, ei, jnp.asarray(w)),
            tm.CoEDModel(4, HID, num_layers=3, alpha=0.6, normalize=True,
                         self_feature_transform=True,
                         jumping_knowledge="att", drop_rate=0.0),
            (tx, tei, _t(w)), _emb((N, 4)),
            # a softmax over the layers ignores a constant added to every
            # score: the score's bias has gradient 0 by the math
            zero=("JumpingKnowledge_0/Dense_0/bias",)),
        "coed_plain": _case(jm.CoEDModel(4, HID, drop_rate=0.0), (x, ei),
                            tm.CoEDModel(4, HID, drop_rate=0.0), (tx, tei),
                            _emb((N, 4))),
        "gnrf": _case(jm.GNRFModel(4, HID, num_steps=8, dropout=0.0),
                      (x, ei), tm.GNRFModel(4, HID, num_steps=8, dropout=0.0),
                      (tx, tei), _emb((N, 4))),
        # with damping a node whose only out-edge is its self-loop moves
        # along a unit vector of rounding noise (ROADMAP C31): a ring
        # gives every node another out-edge
        "gnrf_damping_channel": _case(
            jm.GNRFModel(4, HID, channel_curv=True, damping=True,
                         t_end=2.0, num_steps=4, dropout=0.0),
            (x, jnp.asarray(EI_RING)),
            tm.GNRFModel(4, HID, channel_curv=True, damping=True,
                         t_end=2.0, num_steps=4, dropout=0.0),
            (tx, _t(EI_RING)), _emb((N, 4))),
        "gnrf_scalar": _case(
            jm.GNRFModel(4, HID, edgenet=False, num_steps=5, dropout=0.0),
            (x, ei), tm.GNRFModel(4, HID, edgenet=False, num_steps=5,
                                  dropout=0.0), (tx, tei), _emb((N, 4))),
        "grace_pot_loss": _case(
            jm.GracePOTModel(HID, 12), two, tm.GracePOTModel(HID, 12),
            ttwo, IDENT, method="loss",
            tcall=lambda m, *a: m.loss(*a)),
        "grace_pot_embed": _case(
            jm.GracePOTModel(HID, 12), (x, ei, jnp.asarray(m1)),
            tm.GracePOTModel(HID, 12), (tx, tei, _t(m1)), _emb((N, HID))),
        "grace_pot_k3": _case(
            jm.GracePOTModel(HID, 12, tau=0.4, k=3), two,
            tm.GracePOTModel(HID, 12, tau=0.4, k=3), ttwo, IDENT,
            method="loss", tcall=lambda m, *a: m.loss(*a)),
        "grace_spco_loss": _case(jm.GraceSpcoModel(HID, 12), two,
                                 tm.GraceSpcoModel(HID, 12), ttwo, IDENT),
        "grace_spco_embed": _case(jm.GraceSpcoModel(HID, 12),
                                  (x, ei, jnp.asarray(m1)),
                                  tm.GraceSpcoModel(HID, 12),
                                  (tx, tei, _t(m1)), _emb((N, HID))),
    }


CASES = _cases()
_INIT_FROM = {"grace_pot_embed": "grace_pot_loss",
              "grace_spco_embed": "grace_spco_loss"}


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    c = CASES[_INIT_FROM.get(name, name)]
    kw = {} if c["method"] is None else {"method": c["method"]}
    return jax.jit(functools.partial(c["j"].init, **kw))(
        {"params": KEY, "dropout": KEY}, *c["jin"])


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's init tree, its output and the gradients of its loss,
    compiled once."""
    c = CASES[name]
    params = _jax_init(name)
    kw = {} if c["method"] is None else {"method": c["method"]}

    def loss(p):
        out = c["j"].apply(p, *c["jin"], **kw)
        return c["loss"][0](out), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_output_and_grads_match_jax(name):
    c = CASES[name]
    params, want, grads = _jax_case(name)
    model = load_jax_params(c["t"], params).eval()
    model.zero_grad(set_to_none=True)
    out = (c["tcall"] or (lambda m, *a: m(*a)))(model, *c["tin"])
    c["loss"][1](out).backward()
    for got_leaf, want_leaf in zip(_leaves(out), _leaves(want)):
        _check(got_leaf, want_leaf, TOL)
    _check_grads(model, grads, TOL, zero=c["zero"])


def test_heat_groups_by_source():
    """HEAT's softmax and sum run over each node's out-edges: node 0
    sends only its self-loop, so its row is that one message (alpha 1),
    and a node that sends no edge at all gives a zero row."""
    conv = tc.HEATConv(FEAT, 5, 4, node_emb_size=6, edge_attr_emb_size=4,
                       edge_type_emb_size=4, out_channels=3, heads=2)
    ei = np.concatenate([EI[:, EI[0] != 1], [[0], [5]]], 1)
    attr, et = _cot((ei.shape[1], 5), 1), _cot((ei.shape[1], 4), 2)
    with torch.no_grad():
        out = conv(_t(X), _t(ei), _t(attr), _t(et))
    assert float(out[1].abs().max()) == 0.0
    assert float(out[0].abs().max()) > 0.0


def test_odeint_rk4_matches_jax():
    """A nonlinear, time-dependent field integrated by both packages."""
    y0 = _cot((6, 3), 3)
    a = _cot((3, 3), 4) * 0.5
    want = jm.odeint_rk4(lambda t, y: jnp.tanh(y @ a) * jnp.cos(t) - 0.1 * y,
                         jnp.asarray(y0), 0.0, 1.5, num_steps=7)
    got = tm.odeint_rk4(lambda t, y: torch.tanh(y @ _t(a)) * np.cos(t)
                        - 0.1 * y, _t(y0), 0.0, 1.5, num_steps=7)
    _check(got, want, TOL)


def test_grace_pot_bounds_are_jax():
    for lc in (0, 1, 5):
        for a, b in zip(tm.grace_pot_bounds(EI, N, lc),
                        jm.grace_pot_bounds(EI, N, lc)):
            np.testing.assert_array_equal(a, b)


def test_pot_score_and_loss_match_jax():
    """The certificate score on bounds of a node subset, with rows of the
    pre-activations on each side of 0 (every branch of the relaxation),
    and its hinge, with gradients in z2, XW and HW."""
    up, low = jm.grace_pot_bounds(EI, N)
    idx = np.arange(0, N, 2)
    A_add = ((up + low) / 2)[np.ix_(idx, idx)]
    A_sub = ((up - low) / 2)[np.ix_(idx, idx)]
    z2, XW, HW = (_cot((len(idx), 6), s) for s in (1, 2, 3))

    def jfn(z, a, b):
        s = jm.GracePOTModel.pot_score(z, A_add, A_sub, a, b)
        return jm.GracePOTModel.pot_loss(s), s

    (jl, js), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                      has_aux=True)(z2, XW, HW)
    ins = [_t(a).requires_grad_() for a in (z2, XW, HW)]
    ts = tm.GracePOTModel.pot_score(ins[0], _t(A_add), _t(A_sub), *ins[1:])
    tl = tm.GracePOTModel.pot_loss(ts)
    tl.backward()
    _check(ts, js, TOL)
    _check(tl, jl, TOL)
    for t, g in zip(ins, jg):
        _check(t.grad, g, TOL)


# -- the vector quantisers ----------------------------------------------

DIM, CODES = 6, 4


def _vq_rows(kind, embed):
    """Rows for the quantiser: "clustered" puts 60 rows near each code
    (every code gets 60 > 10 rows, so no code's running count falls below
    2 after a step at decay 0.8: none is dead); "few" gives 7 random rows
    (codes are dead and refreshed)."""
    rng = np.random.default_rng(8)
    if kind == "clustered":
        c = np.arange(60 * CODES) % CODES
        return (embed[c] * 2.0 + 0.05 * rng.normal(size=(len(c), DIM))
                ).astype(np.float32)
    return rng.normal(size=(7, DIM)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_vq(kind, train):
    """JAX's VectorQuantize on the rows: its init state, the outputs, the
    gradient of sum(q * g) + commit in x, and the state after the
    call."""
    jmod = jm.VectorQuantize(DIM, CODES)
    state = jmod.init(KEY, jnp.zeros((3, DIM)))
    x = _vq_rows(kind, np.asarray(state["vq_stats"]["embed"]))
    g = _cot(x.shape, 5)

    def f(x):
        (q, ind, commit), new = jmod.apply(state, x, train=train,
                                           mutable=["vq_stats"])
        return jnp.sum(q * g) + commit, (q, ind, commit, new)

    grad, (q, ind, commit, new) = jax.jit(jax.grad(f, has_aux=True))(x)
    tree = jax.tree_util.tree_map(np.asarray, (state, q, ind, commit, new,
                                               grad))
    return x, g, tree


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["clustered", "few"])
def test_vector_quantize_matches_jax(kind, train):
    """The code ids exactly; the quantised rows, the commitment loss and
    the gradient in x at 1e-5; in training mode the running statistics
    after the call (EMA, smoothing, dead codes refreshed round-robin from
    the rows) at 1e-5 of each one's max."""
    x, g, (state, q, ind, commit, new, grad) = _jax_vq(kind, train)
    vq = load_jax_params(tm.VectorQuantize(DIM, CODES),
                         {"params": {}, "vq_stats": state["vq_stats"]})
    vq.train(train)
    tx = _t(x).requires_grad_()
    tq, tind, tcommit = vq(tx)
    ((tq * _t(g)).sum() + tcommit).backward()
    np.testing.assert_array_equal(tind.numpy(), ind)
    _check(tq, q, TOL)
    _check(tcommit, commit, TOL)
    _check(tx.grad, grad, TOL)
    dead = new["vq_stats"]["cluster_size"] == 2.0
    if train and kind == "clustered":
        assert not dead.any()
    if train and kind == "few":
        assert dead.any()
    after = new["vq_stats"] if train else state["vq_stats"]
    for name, buf in (("embed", vq.embed), ("embed_avg", vq.embed_avg),
                      ("cluster_size", vq.cluster_size)):
        _check(buf, after[name], TOL)


def test_vector_quantize_own_codebook_follows_the_generator():
    a = tm.VectorQuantize(DIM, CODES, generator=torch.Generator()
                          .manual_seed(4))
    b = tm.VectorQuantize(DIM, CODES, generator=torch.Generator()
                          .manual_seed(4))
    assert torch.equal(a.embed, b.embed) and torch.equal(a.embed,
                                                         a.embed_avg)
    lim = (6.0 / (DIM + CODES)) ** 0.5
    assert float(a.embed.abs().max()) <= lim
    assert not a.cluster_size.any()


def _nodeid(gnn):
    kw = dict(local_layers=2, dropout=0.0, num_codes=5, gnn=gnn,
              pre_ln=gnn == "gcn")
    return (jm.NodeIDModel(FEAT, 4, 3, heads=2, **kw),
            tm.NodeIDModel(FEAT, 4, 3, heads=2, **kw))


@functools.lru_cache(maxsize=None)
def _jax_nodeid(gnn, train):
    """JAX's NodeIDModel: its variables, outputs, the gradients of the
    loss in the parameters and the ``vq_stats`` after the call."""
    jmod, _ = _nodeid(gnn)
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    variables = jax.jit(jmod.init)(KEY, x, ei)
    g1, g2 = _cot((N, 3), 1), _cot((N, 6), 2)

    def f(p):
        out, new = jmod.apply({"params": p,
                               "vq_stats": variables["vq_stats"]}, x, ei,
                              train=train, mutable=["vq_stats"],
                              rngs={"dropout": KEY})
        logits, commit, ids, gnn_id = out
        loss = jnp.sum(logits * g1) + commit + jnp.sum(gnn_id * g2)
        return loss, (out, new)

    grads, (out, new) = jax.jit(jax.grad(f, has_aux=True))(
        variables["params"])
    tree = jax.tree_util.tree_map(np.asarray, (variables, out, new))
    return tree + ({"params": grads}, g1, g2)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("gnn", ["gat", "gcn"])
def test_nodeid_matches_jax(gnn, train):
    """Logits, commitment loss, code ids (exactly) and the id head at
    1e-5, every parameter's gradient, and in training mode every
    codebook's state after the step."""
    variables, out, new, grads, g1, g2 = _jax_nodeid(gnn, train)
    _, model = _nodeid(gnn)
    load_jax_params(model, variables).train(train)
    logits, commit, ids, gnn_id = model(_t(X), _t(EI))
    ((logits * _t(g1)).sum() + commit + (gnn_id * _t(g2)).sum()).backward()
    np.testing.assert_array_equal(ids.numpy(), out[2])
    for got, want in zip((logits, commit, gnn_id), (out[0], out[1],
                                                    out[3])):
        _check(got, want, TOL)
    _check_grads(model, grads, TOL)
    after = dict(_flat(new["vq_stats"] if train
                       else variables["vq_stats"]))
    for i, rvq in enumerate(model.rvqs):
        for j, vq in enumerate(rvq.vqs):
            for name in ("embed", "embed_avg", "cluster_size"):
                _check(getattr(vq, name), after[f"rvq{i}/vq{j}/{name}"],
                       TOL)


def test_vq_state_load_refuses_a_mismatched_tree():
    _, model = _nodeid("gat")
    variables = _jax_nodeid("gat", False)[0]
    bad = {"params": variables["params"],
           "vq_stats": {k: v for k, v in variables["vq_stats"].items()
                        if k != "rvq1"}}
    with pytest.raises(KeyError, match="vq_stats"):
        load_jax_params(model, bad)


def test_dropout_draws_from_the_generator():
    """Training mode with dropout: one generator state gives one output,
    which differs from the eval forward (GNRF, HEAT, CoED, NodeID)."""
    tx, tei = _t(X), _t(EI)
    attr, et = _t(_cot((NE, 5), 1)), _t(_cot((NE, 4), 2))
    for model, inputs in (
            (tm.GNRFModel(4, HID, num_steps=2, dropout=0.5), (tx, tei)),
            (tm.HEATModel(8, 7, 6, 8, 6, 5, heads=2, dropout_rate=0.5),
             (_t(_cot((N, 5, 4), 2)), tei, attr, et)),
            (tm.CoEDModel(4, HID, drop_rate=0.5), (tx, tei)),
            (tm.NodeIDModel(FEAT, 4, 3, local_layers=1, num_codes=5),
             (tx, tei))):
        model.eval()
        first = _leaves(model(*inputs))[0].detach()
        model.train()
        outs = [_leaves(model(*inputs,
                              generator=torch.Generator().manual_seed(2)))[0]
                for _ in range(2)]
        assert torch.equal(outs[0], outs[1])
        assert not torch.allclose(outs[0], first)


def test_c31_gnrf_damping_amplifies_rounding_at_a_lone_self_loop():
    """ROADMAP C31. With ``damping`` the field is the mean tangential move
    over sqrt(|move|^2 + 1e-8): unit rows wherever a node moves, but a
    node whose only out-edge is its self-loop moves by (1 - |H_i|^2) H_i,
    zero but for rounding (~1e-8), which the division scales up to 1e4
    times. So that row is rounding noise of up to ~1e-3 whose value no two
    packages share; the parity case runs on a ring that gives every node
    another out-edge."""
    torch.manual_seed(0)
    field = tm.GNRFModel(4, HID, damping=True).ode_block
    h = _t(_cot((N, HID), 3))
    lone = [i for i in range(N) if (EI[0] == i).sum() == 1]
    assert 0 in lone
    with torch.no_grad():
        out = field(h, _t(EI), N)
    norms = torch.linalg.vector_norm(out, dim=1)
    moving = [i for i in range(N) if i not in lone]
    assert float(norms[lone].max()) < 1e-2
    assert float((norms[moving] - 1).abs().max()) < 1e-3
