"""The slice's trainer twins (`gammagl_tpu_torch/examples/`: citgnn,
database, drgst, dropedge, gen, deepwalk, node2vec, metapath2vec,
graphgan, herec, glnn, ltd, dfad_gnn, seal, cogsl, defog) against the JAX
scripts of `examples/<name>/`.

Each twin has the JAX script's flags and defaults (read from its
``__main__`` block by AST; the database script's by hand). Its loop,
from the JAX init and with JAX's draws handed in (dropedge's edge mask,
DeFoG's times and noising draws; dropout off), gives the JAX loop's
losses over a few epochs at rtol 1e-5; the JAX loops are the scripts'
steps on the same data (each compiled once), on a small graph or on the
data the script builds itself (the synthetic typed graph, DeFoG's
graphs). Host draws (walks, batches, links, views) come from the same
numpy streams in both. Every model is COO in both packages.
"""

import functools
import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import examples.common as jax_common  # noqa: E402
import gammagl_tpu.models as jm  # noqa: E402
from gammagl_tpu.layers.pool import sparse_mincut_losses as jax_mincut  # noqa
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from gammagl_tpu.utils import calc_gcn_norm as jax_gcn_norm  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402
from tests.test_torch_simple_twins import _tiny_data  # noqa: E402
from tests.test_torch_ssl_twins import _jax_script  # noqa: E402

from gammagl_tpu_torch.examples import (  # noqa: E402
    citgnn_trainer, cogsl_trainer, database_trainer, deepwalk_trainer,
    defog_trainer, dfad_gnn_trainer, drgst_trainer, dropedge_trainer,
    gen_trainer, glnn_trainer, graphgan_trainer, herec_trainer,
    ltd_trainer, metapath2vec_trainer, node2vec_trainer, seal_trainer)

TWINS = {"citgnn": citgnn_trainer, "database": database_trainer,
         "drgst": drgst_trainer, "dropedge": dropedge_trainer,
         "gen": gen_trainer, "deepwalk": deepwalk_trainer,
         "node2vec": node2vec_trainer, "metapath2vec": metapath2vec_trainer,
         "graphgan": graphgan_trainer, "herec": herec_trainer,
         "glnn": glnn_trainer, "ltd": ltd_trainer,
         "dfad_gnn": dfad_gnn_trainer, "seal": seal_trainer,
         "cogsl": cogsl_trainer, "defog": defog_trainer}
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    monkeypatch.delenv("GGL_REFERENCE_ROOT", raising=False)


@functools.lru_cache(maxsize=None)
def _script(name):
    if name == "database":  # examples/database/cora_store.py
        import importlib
        return (importlib.import_module("examples.database.cora_store"),
                jax_common.base_parser(hidden_dim=16, n_epoch=50,
                                       lr=0.01).parse_args([]))
    return _jax_script(name)


def _flags(name, **overrides):
    """(JAX script module, its default args, the twin's args on the CPU),
    after checking the twin's flags are the script's; then both take
    ``overrides``."""
    jmod, jargs = _script(name)
    jargs = type(jargs)(**vars(jargs))
    targs = TWINS[name].parser().parse_args(["--device", "cpu"])
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)
    for k, v in overrides.items():
        setattr(jargs, k, v)
        setattr(targs, k, v)
    return jmod, jargs, targs


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _adam(lr, decay=None):
    return optax.adam(lr) if decay is None else optax.chain(
        optax.add_decayed_weights(decay), optax.adam(lr))


def _losses(params, loss_of, tx, inputs):
    """Steps of ``tx`` on ``loss_of(params, *inp)``, one for each ``inp``
    of ``inputs``, the step compiled once: (losses, final params)."""
    @jax.jit
    def step(p, s, *inp):
        loss, g = jax.value_and_grad(loss_of)(p, *inp)
        u, s = tx.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    state, out = tx.init(params), []
    for inp in inputs:
        params, state, loss = step(params, state, *inp)
        out.append(float(loss))
    return out, params


def _data(seed=8):
    return _tiny_data(seed)


def _dg(data):
    """The JAX examples' ``device_graph`` of numpy arrays."""
    n = data["x"].shape[0]
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    return {"x": jnp.asarray(data["x"]), "edge_index": jnp.asarray(ei),
            "y": jnp.asarray(data["y"]),
            "train_mask": jnp.asarray(data["train_mask"]),
            "test_mask": jnp.asarray(data["test_mask"])}


def _gcn_teacher(jargs, data, n_epoch, drop=0.0):
    """The JAX GCN (no dropout) on ``data``'s device graph: (model, init
    tree, its losses over ``n_epoch`` Adam steps, trained params)."""
    d = _dg(data)
    model = jm.GCNModel(hidden_dim=jargs.hidden_dim,
                        num_class=int(data["y"].max()) + 1, drop_rate=drop)
    params = model.init(jax.random.PRNGKey(jargs.seed), d["x"],
                        d["edge_index"])
    losses, trained = _losses(
        params, lambda p: jax_loss(model.apply(p, d["x"], d["edge_index"]),
                                   d["y"], d["train_mask"]),
        _adam(jargs.lr), [()] * n_epoch)
    return model, params, losses, trained


# -- the five A10 twins ----------------------------------------------------

def test_citgnn_twin_matches_the_jax_loop():
    """On the synthetic path (no reference checkout): the shifted graph
    from the same numpy draws, then 3 steps of 0.55 CE + 0.25 mincut +
    0.2 ortho (dropout off) from the JAX init of the GCN and the head."""
    jmod, jargs, targs = _flags("citgnn", drop_rate=0.0, n_epoch=STEPS,
                                clusters=5)
    data = _data()
    rng = np.random.default_rng(jargs.seed)
    extra = rng.integers(0, 60, (2, int(data["edge_index"].shape[1]
                                        * float(jargs.ss))))
    shifted = citgnn_trainer.shift_edges(data["edge_index"], 60, targs.ss,
                                         targs.seed)
    np.testing.assert_array_equal(
        shifted, np.concatenate([data["edge_index"], extra], 1))
    n = 60
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    w = jax_gcn_norm(ei, n)
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    mask = jnp.asarray(data["train_mask"])
    model = jm.GCNModel(hidden_dim=jargs.hidden_dim, num_class=4,
                        drop_rate=0.0)
    head = jmod.AssignmentMLP(jargs.clusters)
    key = jax.random.PRNGKey(jargs.seed)
    gparams = model.init({"params": key, "dropout": key}, x, ei, w)

    def first_layer(p):
        _, inter = model.apply(
            p, x, ei, w, train=True, rngs={"dropout": key},
            capture_intermediates=lambda mdl, name: name == "__call__")
        convs = [v for k, v in inter["intermediates"].items()
                 if k.startswith("GCNConv")]
        return jax.nn.relu(convs[0]["__call__"][0])

    hparams = head.init(key, first_layer(gparams))

    def loss_of(p):
        logits = model.apply(p["gcn"], x, ei, w, train=True,
                             rngs={"dropout": key})
        h = first_layer(p["gcn"])
        mc, ortho = jax_mincut(head.apply(p["head"], h), ei, n)
        return (0.55 * jax_loss(logits, y, mask) + 0.25 * mc
                + 0.2 * ortho)

    init = {"gcn": gparams, "head": hparams}
    want, _ = _losses(init, loss_of, _adam(jargs.lr, jargs.l2_coef),
                      [()] * STEPS)
    got = citgnn_trainer.main(targs, data=dict(
        data, test_edge_index=shifted), params={
        "gcn": _np_tree(gparams), "head": _np_tree(hparams)})
    _close(got["losses"], want)


def test_database_twin_matches_the_jax_loop():
    jmod, jargs, targs = _flags("database", n_epoch=STEPS)
    data = _data()
    d = _dg(data)
    x, ei = jnp.asarray(data["x"]), jnp.asarray(data["edge_index"])
    model = jm.GCNModel(hidden_dim=jargs.hidden_dim, num_class=4,
                        drop_rate=0.0)
    params = model.init(jax.random.PRNGKey(jargs.seed), x, ei)
    want, _ = _losses(params, lambda p: jax_loss(
        model.apply(p, x, ei), d["y"], d["train_mask"]),
        _adam(jargs.lr), [()] * STEPS)
    got = database_trainer.main(targs, data=data, params=_np_tree(params))
    _close(got["losses"], want)
    for a, b in zip(database_trainer.round_trip(data),
                    (data["x"], data["y"], data["edge_index"])):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_drgst_twin_matches_the_jax_loop():
    """2 stages of 2 steps at threshold 0.3, so pseudo-labels join: the
    losses, and the labels each stage adds."""
    _, jargs, targs = _flags("drgst", n_epoch=2, stages=2, threshold=0.3)
    data = _data()
    d = _dg(data)
    x, ei = d["x"], d["edge_index"]
    model, params, _, _ = _gcn_teacher(jargs, data, 0)
    y, tm = np.asarray(data["y"]).copy(), np.asarray(data["train_mask"])
    want, added, p = [], [], params
    for _ in range(jargs.stages):
        ls, p = _losses(p, lambda q, ym, m: jax_loss(model.apply(q, x, ei),
                                                     ym, m),
                        _adam(jargs.lr),
                        [(jnp.asarray(y), jnp.asarray(tm))] * jargs.n_epoch)
        want += ls
        probs = jax.nn.softmax(model.apply(p, x, ei))
        conf = np.asarray(probs.max(1))
        new = (conf > jargs.threshold) & ~tm
        y[new] = np.asarray(probs.argmax(1))[new]
        tm = tm | new
        added.append(int(new.sum()))
    got = drgst_trainer.main(targs, data=data, params=_np_tree(params))
    _close(got["losses"], want)
    assert got["added"] == added and sum(added) > 0


def test_dropedge_twin_matches_the_jax_loop(monkeypatch):
    """The JAX Net's edge mask (``jax.random.bernoulli``) fixed to one
    drawn mask, handed to the twin as ``keep``; dropout off; 3 steps of
    Adam with decayed weights."""
    jmod, jargs, targs = _flags("dropedge", drop_rate=0.0, n_epoch=STEPS)
    data = _data()
    d = _dg(data)
    E = d["edge_index"].shape[1]
    keep = np.random.default_rng(3).random(E) < 0.5
    real = jax.random.bernoulli
    monkeypatch.setattr(jax.random, "bernoulli", lambda k, p, shape: (
        jnp.asarray(keep) if tuple(shape) == (E,) else real(k, p, shape)))
    model = jmod.Net(hidden_dim=jargs.hidden_dim, num_class=4,
                     drop_rate=0.0)
    key = jax.random.PRNGKey(jargs.seed)
    x, ei = d["x"], d["edge_index"]
    params = model.init({"params": key, "dropout": key}, x, ei)
    want, _ = _losses(params, lambda p: jax_loss(model.apply(
        p, x, ei, train=True, rngs={"dropout": key}), d["y"],
        d["train_mask"]), _adam(jargs.lr, jargs.l2_coef), [()] * STEPS)
    got = dropedge_trainer.main(targs, data=data, params=_np_tree(params),
                                forward_kwargs={"keep": torch.from_numpy(
                                    keep)})
    _close(got["losses"][:STEPS], want)


def test_gen_twin_matches_the_jax_loop():
    """2 rounds of 2 steps, the EM between them on the same observations:
    the losses and the estimated graph's size a round."""
    from gammagl_tpu.models import GEstimationN as JaxGEN
    _, jargs, targs = _flags("gen", n_epoch=2)
    data = _data()
    d = _dg(data)
    x = d["x"]
    n = 60
    model, params, _, _ = _gcn_teacher(jargs, data, 0)
    ei0 = np.asarray(d["edge_index"])
    est = JaxGEN(n, 4, ei0, np.asarray(d["y"]),
                 np.nonzero(np.asarray(d["train_mask"]))[0])
    want, edges, cur, p = [], [], d["edge_index"], params
    xf = np.asarray(x)
    nn_idx = np.argsort(-(xf @ xf.T), axis=1)[:, 1:6]
    knn = np.zeros((n, n), np.int64)
    knn[np.repeat(np.arange(n), 5), nn_idx.reshape(-1)] = 1
    for _ in range(jargs.iters):
        ls, p = _losses(p, lambda q, e: jax_loss(model.apply(q, x, e),
                                                 d["y"], d["train_mask"]),
                        _adam(jargs.lr), [(cur,)] * jargs.n_epoch)
        want += ls
        pred = np.asarray(jnp.argmax(model.apply(p, x, cur), 1))
        est.reset_obs()
        adj = np.zeros((n, n), np.int64)
        adj[np.asarray(cur)[0], np.asarray(cur)[1]] = 1
        est.update_obs(adj)
        est.update_obs(knn)
        Q = est.em(pred, seed=jargs.seed)[3]
        new = np.stack(np.nonzero(Q > jargs.q_threshold))
        if new.shape[1] > 0:
            cur = jnp.asarray(new)
        edges.append(int(new.shape[1]))
    got = gen_trainer.main(targs, data=data, params=_np_tree(params))
    _close(got["losses"], want)
    assert got["edges"] == edges


# -- embedding models -------------------------------------------------------

def _walk_losses(model_cls, loader_ei, n, jargs, batch_size, n_epoch,
                 lr, walk_length, **kw):
    """The JAX skip-gram loop: init on the loader's first batch, then an
    Adam step a batch for ``n_epoch`` epochs."""
    model = model_cls(num_nodes=n, embedding_dim=jargs.hidden_dim,
                      walk_length=walk_length, **kw)
    loader = model.make_loader(loader_ei, batch_size=batch_size,
                               seed=jargs.seed)
    pos, neg = next(iter(loader))
    params = model.init(jax.random.PRNGKey(jargs.seed), jnp.asarray(pos),
                        jnp.asarray(neg))
    batches = [(jnp.asarray(p), jnp.asarray(q)) for _ in range(n_epoch)
               for p, q in loader]
    want, _ = _losses(params, lambda p, a, b: model.apply(p, a, b),
                      _adam(lr), batches)
    return want, params


@pytest.mark.parametrize("name", ["deepwalk", "node2vec"])
def test_walk_twin_matches_the_jax_loop(name):
    """Batches of 20 walks over the 60-node graph, one epoch: 3 steps."""
    _, jargs, targs = _flags(name, n_epoch=1, batch_size=20,
                             hidden_dim=16)
    data = _data()
    kw = {"p": jargs.p, "q": jargs.q} if name == "node2vec" else {}
    cls = jm.Node2Vec if name == "node2vec" else jm.DeepWalk
    want, params = _walk_losses(cls, data["edge_index"], 60, jargs, 20, 1,
                                jargs.lr, 10, **kw)
    got = TWINS[name].main(targs, data=data, params=_np_tree(params))
    assert len(want) == STEPS
    _close(got["losses"], want)


def test_metapath2vec_twin_matches_the_jax_loop():
    _, jargs, targs = _flags("metapath2vec", n_epoch=STEPS)
    hg, _ = jax_common.synthetic_hetero()
    ei_dict = {k: np.asarray(v) for k, v in hg.edge_index_dict.items()}
    n_dict = {"movie": 200, "director": 60}
    model = jm.MetaPath2Vec(num_nodes_dict=n_dict,
                            metapath=metapath2vec_trainer.METAPATH,
                            embedding_dim=jargs.hidden_dim, walk_length=4)
    rng = np.random.default_rng(jargs.seed)
    batches = []
    for _ in range(STEPS):
        starts = rng.integers(0, 200, 128)
        walks = model.sample_walks(ei_dict, starts, rng=rng)
        neg = rng.integers(0, 260, (walks.shape[0], 1, walks.shape[1]))
        batches.append((jnp.asarray(walks), jnp.asarray(neg)))
    params = model.init(jax.random.PRNGKey(jargs.seed), *batches[0])
    want, _ = _losses(params, lambda p, a, b: model.apply(p, a, b),
                      _adam(jargs.lr), batches)
    got = metapath2vec_trainer.main(targs, params=_np_tree(params))
    _close(got["losses"], want)


def test_herec_twin_matches_the_jax_loop():
    """The mdm table's steps (2 batches of 128 an epoch, 2 epochs), then
    the fused embeddings from the same table."""
    _, jargs, targs = _flags("herec", n_epoch=2)
    hg, _ = jax_common.synthetic_hetero()
    mdm = np.asarray(hg[("movie", "mdm", "movie")].edge_index)
    want, params = _walk_losses(jm.Node2Vec, mdm, 200, jargs, 128, 2, 0.01,
                                5)
    got = herec_trainer.main(targs, params=_np_tree(params))
    _close(got["losses"], want)
    assert got["fused"].shape == (200, 2 * jargs.hidden_dim)


def test_graphgan_twin_matches_the_jax_loop():
    """One optax state over all four parameters, a discriminator and a
    generator step an epoch (the twin fills the unreached parameters'
    gradients with zeros, as optax sees them): both losses of 3 epochs."""
    _, jargs, targs = _flags("graphgan", n_epoch=STEPS)
    data = _data()
    ei = data["edge_index"]
    rng = np.random.default_rng(jargs.seed)

    def batch():
        pos = ei[:, rng.integers(0, ei.shape[1], 256)]
        fake = rng.integers(0, 60, 256)
        return (jnp.asarray(np.concatenate([pos[0], pos[0]])),
                jnp.asarray(np.concatenate([pos[1], fake])),
                jnp.asarray(np.concatenate([np.ones(256), np.zeros(256)])))

    model = jm.GraphGAN(num_nodes=60, embedding_dim=jargs.hidden_dim)
    params = model.init(jax.random.PRNGKey(jargs.seed), *batch())
    tx = optax.adam(jargs.lr)

    @jax.jit
    def two_steps(p, s, u, v, lab):
        dl, g = jax.value_and_grad(lambda q: model.apply(q, u, v, lab))(p)
        upd, s = tx.update(g, s)
        p = optax.apply_updates(p, upd)
        gl, g = jax.value_and_grad(lambda q: model.apply(
            q, u[:256], v[256:]))(p)
        upd, s = tx.update(g, s)
        return optax.apply_updates(p, upd), s, dl, gl

    p, s, want = params, tx.init(params), []
    for _ in range(STEPS):
        p, s, dl, gl = two_steps(p, s, *batch())
        want.append((float(dl), float(gl)))
    got = graphgan_trainer.main(targs, data=data, params=_np_tree(params))
    _close(got["losses"], want)


# -- distillation ---------------------------------------------------------

def _student(jargs, data):
    x = jnp.asarray(data["x"])
    student = jm.GLNNStudent(hidden_dim=jargs.hidden_dim, num_class=4,
                             drop_rate=0.0)
    return student, student.init(jax.random.PRNGKey(jargs.seed), x)


def test_glnn_twin_matches_the_jax_loop():
    """2 teacher steps, then 4 student steps on `distill_loss`."""
    _, jargs, targs = _flags("glnn", n_epoch=2)
    data = _data()
    d = _dg(data)
    teacher, tparams, t_want, trained = _gcn_teacher(jargs, data, 2)
    t_logits = teacher.apply(trained, d["x"], d["edge_index"])
    student, sparams = _student(jargs, data)
    want, _ = _losses(sparams, lambda p: jm.distill_loss(
        student.apply(p, d["x"]), t_logits, d["y"], d["train_mask"],
        lam=0.5), _adam(jargs.lr), [()] * 4)
    got = glnn_trainer.main(targs, data=data, params={
        "teacher": _np_tree(tparams), "student": _np_tree(sparams)})
    _close(got["teacher_losses"], t_want)
    _close(got["losses"], want)


def test_ltd_twin_matches_the_jax_loop():
    _, jargs, targs = _flags("ltd", n_epoch=2)
    data = _data()
    d = _dg(data)
    teacher, tparams, _, trained = _gcn_teacher(jargs, data, 2)
    t_logits = teacher.apply(trained, d["x"], d["edge_index"])
    student, sparams = _student(jargs, data)
    init = {"student": sparams, "log_temp": jnp.zeros((60, 1))}

    def loss_of(ps):
        temp = jnp.exp(ps["log_temp"])
        soft = jax.nn.softmax(t_logits / temp)
        logits = student.apply(ps["student"], d["x"])
        kd = optax.softmax_cross_entropy(logits / temp, soft).mean()
        return 0.5 * jax_loss(logits, d["y"], d["train_mask"]) + 0.5 * kd

    want, _ = _losses(init, loss_of, _adam(jargs.lr), [()] * 4)
    got = ltd_trainer.main(targs, data=data, params={
        "teacher": _np_tree(tparams), "student": {"params": {
            "student": _np_tree(sparams)["params"],
            "log_temp": np.zeros((60, 1), np.float32)}}})
    _close(got["losses"], want)


def test_dfad_gnn_twin_matches_the_jax_loop():
    """2 teacher steps, then 3 rounds of a student and a generator step,
    each with its own Adam."""
    _, jargs, targs = _flags("dfad_gnn", n_epoch=2)
    data = _data()
    d = _dg(data)
    x, ei = d["x"], d["edge_index"]
    teacher, tparams, _, trained = _gcn_teacher(jargs, data, 2)
    student, sparams = _student(jargs, data)
    gen = jm.GraphEditer(num_features=x.shape[1])
    key = jax.random.PRNGKey(jargs.seed)
    gparams = gen.init(key, x)
    s_tx, g_tx = optax.adam(jargs.lr), optax.adam(jargs.lr)

    @jax.jit
    def round_(sp, gp, so, go):
        xg = gen.apply(gp, x)
        tg = jax.lax.stop_gradient(teacher.apply(trained, xg, ei))
        sl, g = jax.value_and_grad(lambda p: jm.dfad_student_loss(
            student.apply(p, xg), tg))(sp)
        u, so = s_tx.update(g, so)
        sp = optax.apply_updates(sp, u)
        gl, g = jax.value_and_grad(lambda q: jm.dfad_generator_loss(
            student.apply(sp, gen.apply(q, x)),
            teacher.apply(trained, gen.apply(q, x), ei)))(gp)
        u, go = g_tx.update(g, go)
        return sp, optax.apply_updates(gp, u), so, go, sl, gl

    sp, gp, so, go, want = sparams, gparams, s_tx.init(sparams), \
        g_tx.init(gparams), []
    for _ in range(2):
        sp, gp, so, go, sl, gl = round_(sp, gp, so, go)
        want.append((float(sl), float(gl)))
    got = dfad_gnn_trainer.main(targs, data=data, params={
        "teacher": _np_tree(tparams), "student": _np_tree(sparams),
        "generator": _np_tree(gparams)})
    _close(got["losses"], want)


# -- SEAL, CoGSL, DeFoG ---------------------------------------------------

def test_seal_twin_matches_the_jax_loop():
    """Batches of 4 links from the same numpy stream (the twin's
    `subgraph_batch` against the JAX script's, run here), 3 eager steps
    (the JAX script does not jit: sort pooling sizes its batch on the
    host)."""
    jmod, jargs, targs = _flags("seal", n_epoch=STEPS, batch_size=4)
    data = _data()
    ei, n = data["edge_index"], 60
    rng = np.random.default_rng(jargs.seed)
    batches = [seal_trainer.subgraph_batch(ei, n, rng, 4)
               for _ in range(STEPS + 1)]
    model = jm.SEALModel(hidden_dim=jargs.hidden_dim, k=6)
    lab, sei, b, y, ng = (jnp.asarray(a) if not isinstance(a, int) else a
                          for a in batches[0])
    params = model.init(jax.random.PRNGKey(jargs.seed), lab, sei, None, b,
                        ng)
    tx = optax.adam(jargs.lr)
    p, s, want = params, tx.init(params), []
    for batch in batches[1:]:
        lab, sei, b, y, ng = (jnp.asarray(a) if not isinstance(a, int)
                              else a for a in batch)
        loss, g = jax.value_and_grad(lambda q: optax.sigmoid_binary_cross_entropy(
            model.apply(q, lab, sei, None, b, ng)[:, 0],
            y.astype(jnp.float32)).mean())(p)
        u, s = tx.update(g, s)
        p = optax.apply_updates(p, u)
        want.append(float(loss))
    got = seal_trainer.main(targs, data=data, params=_np_tree(params))
    _close(got["losses"], want)


def _cogsl_run(jargs, targs, data):
    """(the JAX loop's losses, the twin's) on ``data``."""
    d = _dg(data)
    x, ei = d["x"], d["edge_index"]
    rng = np.random.default_rng(jargs.seed)
    idx = rng.integers(0, ei.shape[1], min(4000, ei.shape[1]))
    e2 = jnp.asarray(np.asarray(ei)[:, idx][::-1].copy())
    np.testing.assert_array_equal(
        cogsl_trainer.second_view(np.asarray(ei), jargs.seed),
        np.asarray(e2))
    model = jm.CoGSLModel(num_class=4, hidden_dim=jargs.hidden_dim)
    params = model.init(jax.random.PRNGKey(jargs.seed), x, ei, e2)

    def loss_of(p, x, ei, e2):
        (l1, l2, lf), mi = model.apply(p, x, ei, e2)
        return (jax_loss(lf, d["y"], d["train_mask"])
                + 0.5 * jax_loss(l1, d["y"], d["train_mask"])
                + 0.5 * jax_loss(l2, d["y"], d["train_mask"]) - 0.1 * mi)

    want, _ = _losses(params, loss_of, _adam(jargs.lr),
                      [(x, ei, e2)] * STEPS)
    got = cogsl_trainer.main(targs, data=data, params=_np_tree(params))
    return want, got["losses"], np.asarray(e2)


def test_cogsl_twin_matches_the_jax_loop():
    """On a graph where the second view (edges drawn with replacement)
    leaves no node without an edge in: 3 steps. On the small graph, where
    it leaves some: ROADMAP C28 in the JAX script (a node with no edge in
    a view has a zero embedding there at init, and JAX's GRACE term gives
    it NaN gradients, so the JAX loop's second loss is NaN), while the
    port's loop stays finite and its first loss is JAX's."""
    _, jargs, targs = _flags("cogsl", n_epoch=STEPS)
    dense = _tiny_data(8)
    rng = np.random.default_rng(9)
    extra = np.stack([np.repeat(np.arange(60), 12),
                      rng.integers(0, 60, 720)])
    dense["edge_index"] = np.concatenate([dense["edge_index"], extra], 1)
    want, got, e2 = _cogsl_run(jargs, targs, dense)
    assert len(np.unique(e2[1])) == 60
    _close(got, want)
    want, got, e2 = _cogsl_run(jargs, targs, _data())
    assert len(np.unique(e2[1])) < 60
    assert np.isnan(want[1:]).all() and np.isfinite(got).all()
    _close(got[:1], want[:1])


def test_defog_twin_matches_the_jax_loop():
    """The script's graphs (one numpy stream), its times and noising
    draws from its keys handed in (ROADMAP C40), 3 Adam steps."""
    from tests.test_torch_a6e_models import _flow_draws_jax
    _, jargs, targs = _flags("defog", n_epoch=STEPS)
    model = jm.DeFoGModel(**defog_trainer.DIMS)
    rng = np.random.default_rng(jargs.seed)

    def sample_graph():
        X = jax.nn.one_hot(jnp.asarray(rng.integers(0, 4, 8)), 4)
        e = rng.integers(0, 3, (8, 8))
        e = np.triu(e) + np.triu(e, 1).T
        return X, jax.nn.one_hot(jnp.asarray(e), 3)

    X, E = sample_graph()
    y = jnp.zeros(1)
    params = model.init(jax.random.PRNGKey(jargs.seed), X, E, y,
                        jnp.asarray(0.5))
    rng_j = jax.random.PRNGKey(jargs.seed + 1)
    inputs, draws = [], []
    for _ in range(STEPS):
        X1, E1 = sample_graph()
        rng_j, k = jax.random.split(rng_j)
        t = jax.random.uniform(k)
        draws.append((float(t), {
            key: np.array(v) for key, v in _flow_draws_jax(
                k, 8, 4, 3, t).items()}))
        inputs.append((X1, E1, k, t))

    def loss_of(p, X1, E1, k, t):
        Xt, Et = jm.flow_interpolate(k, X1, E1, t)
        pX, pE, _ = model.apply(p, Xt, Et, y, t)
        return (optax.softmax_cross_entropy(pX, X1).mean()
                + optax.softmax_cross_entropy(pE, E1).mean())

    want, _ = _losses(params, loss_of, _adam(jargs.lr), inputs)
    got = defog_trainer.main(targs, params=_np_tree(params),
                             draws=iter(draws))
    _close(got["losses"], want)
