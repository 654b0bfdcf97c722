"""The wave-5 to wave-8 trainer twins (`gammagl_tpu_torch/examples/`:
sign, unifews, hardgat, adagad, sp2gcl, magcl, gcil, amgcn, edgeprompt,
amp, dhn, heat, coed, nodeid, gnrf, grace_pot, grace_spco, fatragnn)
against the JAX trainers of `examples/<name>/<name>_trainer.py`.

Each twin has the JAX script's flags and defaults (read from its
``__main__`` block by AST). Its loop, from the JAX init and with JAX's
draws handed in (the two-view masks) or dropout off, gives the JAX
trainer's first 3 losses at rtol 1e-5; the JAX loops are the scripts'
steps on the same data under one jit, on the data the scripts build
(captured from the JAX ``main`` where the script makes its own: DHN's,
HEAT's and FatraGNN's synthetic inputs). No model here takes a plan in
either package, so both sum on their COO ops.
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
import gammagl_tpu.models as jm  # noqa: E402
from gammagl_tpu.data import Graph as JaxGraph  # noqa: E402
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from gammagl_tpu.transforms import SIGN as JaxSIGN  # noqa: E402
from gammagl_tpu.utils import negative_sampling as jax_neg  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402
from tests.test_torch_simple_twins import _tiny_data  # noqa: E402
from tests.test_torch_ssl_twins import (_device_graph, _jax_script,  # noqa
                                        _masks, _step_keys)

import gammagl_tpu_torch.models as tm  # noqa: E402
from gammagl_tpu_torch.examples import (  # noqa: E402
    adagad_trainer, amgcn_trainer, amp_trainer, coed_trainer, dhn_trainer,
    edgeprompt_trainer, fatragnn_trainer, gcil_trainer, gnrf_trainer,
    grace_pot_trainer, grace_spco_trainer, hardgat_trainer, heat_trainer,
    magcl_trainer, nodeid_trainer, sign_trainer, sp2gcl_trainer,
    unifews_trainer)

TWINS = {"sign": sign_trainer, "unifews": unifews_trainer,
         "hardgat": hardgat_trainer, "adagad": adagad_trainer,
         "sp2gcl": sp2gcl_trainer, "magcl": magcl_trainer,
         "gcil": gcil_trainer, "amgcn": amgcn_trainer,
         "edgeprompt": edgeprompt_trainer, "amp": amp_trainer,
         "dhn": dhn_trainer, "heat": heat_trainer, "coed": coed_trainer,
         "nodeid": nodeid_trainer, "gnrf": gnrf_trainer,
         "grace_pot": grace_pot_trainer, "grace_spco": grace_spco_trainer,
         "fatragnn": fatragnn_trainer}
# twins that build their own synthetic inputs (no node dataset)
OWN_DATA = ("dhn", "heat", "fatragnn")
STEPS = 3


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


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    monkeypatch.delenv("GGL_REFERENCE_ROOT", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # unifews's log directory


@functools.lru_cache(maxsize=None)
def _flags_cached(name):
    return _jax_script(name)


def _flags(name):
    """(JAX script module, its default args, the twin's args on the
    CPU), after checking the twin's flags are the script's."""
    jmod, jargs = _flags_cached(name)
    jargs = type(jargs)(**vars(jargs))
    targs = TWINS[name].parser().parse_args(["--device", "cpu"])
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)
    return jmod, jargs, targs


def _adam_losses(init, loss_of, lr, inputs, decay=None):
    """``init()`` and Adam's state (``lr``; decayed weights first when
    ``decay``) under one jit, then one jitted step of ``loss_of(params,
    *inp)`` for each ``inp`` of ``inputs``: (the losses, the init
    variables)."""
    tx = optax.adam(lr) if decay is None else optax.chain(
        optax.add_decayed_weights(decay), optax.adam(lr))
    state = jax.jit(lambda: JaxTrainState.create(params=init(), tx=tx))()
    params = state.params

    @jax.jit
    def step(state, *inp):
        loss, grads = jax.value_and_grad(loss_of)(state.params, *inp)
        return state.apply_gradients(grads), loss

    losses = []
    for inp in inputs:
        state, loss = step(state, *inp)
        losses.append(float(loss))
    return losses, params


def _close(got, want):
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got["losses"][:STEPS], want, rtol=1e-5)


def _data():
    data = _tiny_data(8)
    return data, _device_graph(data), int(data["y"].max()) + 1


# -- on run_simple_node_trainer: hardgat, edgeprompt, coed, gnrf ----------

@pytest.mark.parametrize("name", ["hardgat", "edgeprompt", "coed", "gnrf"])
def test_simple_loop_twin_matches_the_jax_trainer(name, monkeypatch):
    """The model the JAX script builds (captured from its ``main``), its
    dropout off in both packages, 3 steps of `run_simple_node_trainer`'s
    loop (Adam with decayed weights, ``train=True``) from its init."""
    jmod, jargs, targs = _flags(name)
    data, _, n_class = _data()
    monkeypatch.setattr(jmod, "probe_num_classes", lambda args: n_class)
    monkeypatch.setattr(jmod, "args", jargs, raising=False)  # Net reads it
    monkeypatch.setattr(jmod, "run_simple_node_trainer",
                        lambda model, args, **kw: model)
    jmodel = jmod.main(jargs)
    if name == "coed":
        jmodel = jmodel.clone(drop_rate=0.0)
        monkeypatch.setattr(coed_trainer, "CoEDModel", functools.partial(
            tm.CoEDModel, drop_rate=0.0))
    if name == "gnrf":
        jmodel = jmodel.clone(dropout=0.0)
        monkeypatch.setattr(gnrf_trainer, "GNRFModel", functools.partial(
            tm.GNRFModel, dropout=0.0))
    _, d, _ = _data()
    x, ei, key = d["x"], d["edge_index"], jax.random.PRNGKey(jargs.seed)
    want, params = _adam_losses(
        lambda: jmodel.init({"params": key, "dropout": key}, x, ei),
        lambda p: jax_loss(jmodel.apply(p, x, ei, train=True,
                                        rngs={"dropout": key}), d["y"],
                           d["train_mask"]),
        jargs.lr, [()] * STEPS, decay=jargs.l2_coef)
    targs.n_epoch = STEPS
    _close(TWINS[name].main(targs, data=data, params=_np_tree(params)),
           want)


# -- full-batch loops of their own --------------------------------------

def test_sign_twin_matches_the_jax_trainer():
    """`transforms.SIGN` of both packages on the loaded graph (bitwise),
    then 3 steps (dropout off)."""
    _, jargs, targs = _flags("sign")
    jargs.drop_rate = targs.drop_rate = 0.0
    data, _, n_class = _data()
    g = JaxSIGN(K=jargs.K)(JaxGraph(x=data["x"],
                                    edge_index=data["edge_index"]).numpy())
    jxs = [np.asarray(g.x)] + [np.asarray(g[f"x{k}"])
                               for k in range(1, jargs.K + 1)]
    for a, b in zip(sign_trainer.sign_features(data, jargs.K), jxs):
        np.testing.assert_array_equal(a, b)
    xs = [jnp.asarray(a) for a in jxs]
    model = jm.SIGNModel(num_class=n_class, hidden_dim=jargs.hidden_dim,
                         K=jargs.K, drop_rate=0.0)
    key = jax.random.PRNGKey(jargs.seed)
    y, mask = jnp.asarray(data["y"]), jnp.asarray(data["train_mask"])
    want, params = _adam_losses(
        lambda: model.init({"params": key, "dropout": key}, xs),
        lambda p: jax_loss(model.apply(p, xs, train=True,
                                       rngs={"dropout": key}), y, mask),
        jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    _close(sign_trainer.main(targs, data=data, params=_np_tree(params)),
           want)


def test_unifews_twin_matches_the_jax_trainer(tmp_path):
    _, jargs, targs = _flags("unifews")
    data, d, n_class = _data()
    model = jm.GCNUniFews(num_class=n_class, hidden_dim=jargs.hidden_dim,
                          edge_thr=jargs.edge_thr)
    x, ei = d["x"], d["edge_index"]
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), x, ei),
        lambda p: jax_loss(model.apply(p, x, ei), d["y"], d["train_mask"]),
        jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    got = unifews_trainer.main(targs, data=data, params=_np_tree(params),
                               log_dir=str(tmp_path))
    _close(got, want)
    assert 0.0 < got["sparsity"] < 1.0
    logs = list(tmp_path.rglob("log.txt"))
    assert len(logs) == 1 and "gcn_unifews" in logs[0].read_text()


def test_adagad_twin_matches_the_jax_trainer():
    """The JAX script's anomaly injection and negatives (its numpy draws
    and `negative_sampling` under ``--seed``) are the twin's, then 3
    steps."""
    _, jargs, targs = _flags("adagad")
    data, d, _ = _data()
    rng = np.random.default_rng(jargs.seed + 7)  # the script's draws
    n = data["x"].shape[0]
    n_anom = max(8, n // 20)
    anom = rng.choice(n, n_anom, replace=False)
    x = np.array(d["x"])
    x[anom[:n_anom // 2]] += rng.normal(
        scale=3.0 * x.std() + 1e-6, size=(n_anom // 2, x.shape[1])
    ).astype(x.dtype)
    clique = anom[n_anom // 2:]
    extra = np.stack([np.repeat(clique, 4),
                      rng.choice(clique, 4 * len(clique))])
    ei = np.concatenate([np.asarray(d["edge_index"]), extra], axis=1)
    neg = jax_neg(ei, num_nodes=n, num_neg_samples=ei.shape[1] // 2,
                  rng=np.random.default_rng(jargs.seed))
    got = adagad_trainer.inject_anomalies(np.asarray(d["x"]),
                                          np.asarray(d["edge_index"]),
                                          jargs.seed)
    for a, b in zip(got[:3], (x, ei, neg)):
        np.testing.assert_array_equal(a, b)
    assert got[3].sum() == n_anom
    model = jm.AdaGADModel(hidden_dim=jargs.hidden_dim, latent_dim=8)
    jx, jei, jneg = jnp.asarray(x), jnp.asarray(ei), jnp.asarray(neg)
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), jx, jei, jneg),
        lambda p: model.apply(p, jx, jei, jneg), jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    out = adagad_trainer.main(targs, data=data, params=_np_tree(params))
    _close(out, want)
    assert 0.0 <= out["auc"] <= 1.0


def test_sp2gcl_twin_matches_the_jax_trainer():
    _, jargs, targs = _flags("sp2gcl")
    data, d, _ = _data()
    x, ei = d["x"], d["edge_index"]
    _, u = jm.laplacian_eigh(np.asarray(ei), x.shape[0])
    u = jnp.asarray(u[:, :jargs.spe_dim])
    model = jm.Sp2GCLModel(hidden_dim=jargs.hidden_dim)
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), x, ei, u),
        lambda p: model.apply(p, x, ei, u), jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    _close(sp2gcl_trainer.main(targs, data=data, params=_np_tree(params)),
           want)


def test_amgcn_twin_matches_the_jax_trainer():
    """The script's kNN feature graph, then 3 steps of the loss with the
    consistency term."""
    _, jargs, targs = _flags("amgcn")
    data, d, n_class = _data()
    x, ei = d["x"], d["edge_index"]
    xf = np.asarray(x)
    nn_idx = np.argsort(-(xf @ xf.T), axis=1)[:, 1:6]
    fei = np.stack([np.repeat(np.arange(xf.shape[0]), 5),
                    nn_idx.reshape(-1)])
    np.testing.assert_array_equal(amgcn_trainer.knn_graph(data["x"]), fei)
    fei = jnp.asarray(fei)
    model = jm.SFGCNModel(num_class=n_class, hidden_dim=jargs.hidden_dim)

    def loss_of(p):
        logits, consistency = model.apply(p, x, ei, fei)
        return (jax_loss(logits, d["y"], d["train_mask"])
                + 0.01 * consistency)

    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), x, ei, fei),
        loss_of, jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    _close(amgcn_trainer.main(targs, data=data, params=_np_tree(params)),
           want)


def test_amp_twin_matches_the_jax_trainer():
    _, jargs, targs = _flags("amp")
    data, d, n_class = _data()
    x, ei = d["x"], d["edge_index"]
    model = jm.AMPModel(num_class=n_class, hidden_dim=jargs.hidden_dim,
                        max_steps=4)
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), x, ei),
        lambda p: jax_loss(model.apply(p, x, ei)[0], d["y"],
                           d["train_mask"]), jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    out = amp_trainer.main(targs, data=data, params=_np_tree(params))
    _close(out, want)
    assert 1.0 <= out["depth"] <= 4.0


def test_nodeid_twin_matches_the_jax_trainer(monkeypatch):
    """3 steps in training mode (dropout off in both), the codebooks'
    statistics carried across as JAX's ``vq_stats`` and updated by each
    step in both packages; the losses read the commitment term, so they
    hold only while the running codebooks agree."""
    _, jargs, targs = _flags("nodeid")
    data, d, n_class = _data()
    x, ei = d["x"], d["edge_index"]
    model = jm.NodeIDModel(in_channels=x.shape[1],
                           hidden_channels=jargs.hidden_dim,
                           out_channels=n_class, num_codes=32, dropout=0.0)
    variables = jax.jit(model.init)(jax.random.PRNGKey(jargs.seed), x, ei)
    tx = optax.adam(jargs.lr)

    @jax.jit
    def step(params, stats, opt_state):
        def loss_fn(p):
            (logits, commit, _, _), new = model.apply(
                {"params": p, "vq_stats": stats}, x, ei, train=True,
                mutable=["vq_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            return (jax_loss(logits, d["y"], d["train_mask"])
                    + 0.25 * commit), new
        (loss, new), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state)
        return (optax.apply_updates(params, updates), new["vq_stats"],
                opt_state, loss)

    params, stats = variables["params"], variables["vq_stats"]
    opt_state, want = tx.init(params), []
    for _ in range(STEPS):
        params, stats, opt_state, loss = step(params, stats, opt_state)
        want.append(float(loss))
    monkeypatch.setattr(nodeid_trainer, "NodeIDModel", functools.partial(
        tm.NodeIDModel, dropout=0.0))
    targs.n_epoch = STEPS
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    _close(nodeid_trainer.main(targs, data=data, params=tree), want)


# -- two views: magcl, gcil, grace_pot, grace_spco -------------------------

_TWO_VIEW = {
    "magcl": (lambda a: jm.MAGCLModel(hidden_dim=a.hidden_dim), None),
    "gcil": (lambda a: jm.GCILModel(hidden_dim=a.hidden_dim), None),
    "grace_pot": (lambda a: jm.GracePOTModel(num_hidden=a.hidden_dim,
                                             num_proj_hidden=a.hidden_dim),
                  "loss"),
    "grace_spco": (lambda a: jm.GraceSpcoModel(
        num_hidden=a.hidden_dim, num_proj_hidden=a.hidden_dim), None),
}
# (edge1, feat1, edge2, feat2) of each script's views (C27: the edge rate
# masks the features)
_RATES = {"magcl": (0.2, 0.3, 0.4, 0.4), "gcil": (0.2,) * 4,
          "grace_pot": (0.2, 0.2, 0.3, 0.3),
          "grace_spco": (0.2, 0.2, 0.3, 0.3)}


@pytest.mark.parametrize("name", sorted(_TWO_VIEW))
def test_two_view_twin_matches_the_jax_trainer(name):
    """The JAX init (of the script's form), then 3 steps on the step keys'
    view masks, handed to both packages, with every self-loop kept (a
    node that loses all its in-edges has a zero row, where JAX's
    `grace_loss` has a NaN gradient: ROADMAP C28)."""
    _, jargs, targs = _flags(name)
    de1, df1, de2, df2 = (getattr(jargs, k, r) for k, r in zip(
        ("drop_edge_rate_1", "drop_feature_rate_1", "drop_edge_rate_2",
         "drop_feature_rate_2"), _RATES[name]))
    data, d, _ = _data()
    x, ei = d["x"], d["edge_index"]
    n = x.shape[0]
    make, method = _TWO_VIEW[name]
    model = make(jargs)
    key = jax.random.PRNGKey(jargs.seed)
    kw = {} if method is None else {"method": method}
    ones = jnp.ones(ei.shape[1])
    if name == "grace_pot":
        init_views = (x, ei, None, x, ei, None)
    elif name == "grace_spco":
        init_views = (x, ei, ones, x, ei, ones)
    else:  # run_two_view_ssl's init: views of the key's halves
        k1, k2 = jax.random.split(key)
        xa, wa = jm.drop_edge_and_feature(k1, x, ei, de1, df1)
        xb, wb = jm.drop_edge_and_feature(k2, x, ei, de2, df2)
        init_views = (xa, ei, wa, xb, ei, wb)
    masks = []
    for k in _step_keys(jargs.seed, STEPS):
        ka, kb = jax.random.split(k)
        m = tuple(_masks(kv, x, ei, a, b) for kv, a, b in (
            (ka, de1, df1), (kb, de2, df2)))
        m[0][1][-n:] = m[1][1][-n:] = True  # add_self_loops appends them
        masks.append(m)

    def loss_of(p, fa, ea, fb, eb):
        return model.apply(p, x * fa, ei, ea.astype(x.dtype), x * fb, ei,
                           eb.astype(x.dtype), **kw)

    want, params = _adam_losses(
        lambda: model.init(key, *init_views, **kw), loss_of, jargs.lr,
        [(fa, ea, fb, eb) for (fa, ea), (fb, eb) in masks])
    draws = iter([tuple(tuple(torch.from_numpy(np.array(a)) for a in v)
                        for v in m) for m in masks])
    targs.n_epoch = STEPS
    _close(TWINS[name].main(targs, data=data, params=_np_tree(params),
                            draws=draws), want)


def test_gcil_takes_the_real_views_when_the_files_exist(tmp_path,
                                                        monkeypatch):
    """With perturbed adjacencies under ``GGL_REFERENCE_ROOT`` the gcil
    twin trains on them in turn (the empty residue file skipped), as the
    JAX script does with the files under its reference checkout."""
    import scipy.sparse as sp
    d = tmp_path / "examples" / "gcil" / "dataset" / "cora"
    d.mkdir(parents=True)
    n = 60
    for i in range(4):
        a = sp.random(n, n, density=0.08, random_state=i, format="csr")
        a = ((a + a.T + sp.eye(n)) > 0).astype(np.float32).tocsr()
        if i == 0:  # the empty residue file
            a = sp.csr_matrix((n, n), dtype=np.float32)
        np.savez(d / f"0.01_1_{i}.npz", indptr=a.indptr, indices=a.indices,
                 data=a.data, shape=np.array(a.shape), format="csr")
    monkeypatch.setenv("GGL_REFERENCE_ROOT", str(tmp_path))
    views, got_n = gcil_trainer.real_views("cora")
    assert got_n == n and len(views) == 3
    args = gcil_trainer.parser().parse_args(["--device", "cpu", "--n_epoch",
                                             "2", "--hidden_dim", "8"])
    out = gcil_trainer.main(args)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["probe_acc"] <= 1.0


# -- synthetic inputs of the scripts' own: dhn, heat, fatragnn -------------

class _Captured(Exception):
    pass


def _capture_init(monkeypatch, jmod, cls_name, jargs):
    """The arguments the JAX script's ``main`` hands its model's init."""
    seen = {}
    base = getattr(jmod, cls_name)

    class Capture(base):
        def init(self, rngs, *args, **kw):
            seen["args"] = args
            raise _Captured

    monkeypatch.setattr(jmod, cls_name, Capture)
    with pytest.raises(_Captured):
        jmod.main(jargs)
    return seen["args"]


def test_dhn_twin_matches_the_jax_trainer(monkeypatch):
    """The script's init batch is the twin stream's first, then 3 steps
    on the stream's next batches."""
    jmod, jargs, targs = _flags("dhn")
    n1, n2 = _capture_init(monkeypatch, jmod, "DHNModel", jargs)
    stream = dhn_trainer.batches(jargs.seed)
    first = next(stream)
    np.testing.assert_array_equal(first[0], np.asarray(n1))
    np.testing.assert_array_equal(first[1], np.asarray(n2))
    model = jm.DHNModel(num_fea=dhn_trainer.F_DIM,
                        num_neighbor=dhn_trainer.K, hidden=jargs.hidden_dim)
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), n1, n2),
        lambda p, a, b, y: optax.sigmoid_binary_cross_entropy(
            model.apply(p, a, b)[:, 0], y).mean(), jargs.lr,
        [next(stream) for _ in range(STEPS)])
    targs.n_epoch = STEPS
    out = dhn_trainer.main(targs, params=_np_tree(params))
    _close(out, want)
    assert 0.0 <= out["auc"] <= 1.0


def test_heat_twin_matches_the_jax_trainer(monkeypatch):
    """The script's init scene is the twin's scene 0, then 3 steps on
    scenes 0, 1, 2 (the model in its inference mode, as the script calls
    it)."""
    jmod, jargs, targs = _flags("heat")
    captured = _capture_init(monkeypatch, jmod, "HEATModel", jargs)
    scenes = [heat_trainer.scene(s) for s in range(STEPS)]
    for a, b in zip(scenes[0][:4], captured):
        np.testing.assert_array_equal(a, np.asarray(b))
    model = jm.HEATModel(in_channels_node=16, out_channels=32,
                         out_length=heat_trainer.FUT, node_emb_size=16,
                         edge_attr_emb_size=16, edge_type_emb_size=16,
                         heads=2)
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), *captured),
        lambda p, x, ei, attr, et, y: ((model.apply(p, x, ei, attr, et)
                                        - y) ** 2).mean(), jargs.lr,
        scenes)
    targs.n_epoch = STEPS
    _close(heat_trainer.main(targs, params=_np_tree(params)), want)


@pytest.mark.parametrize("seed", [0, 3])
def test_fatragnn_twin_matches_the_jax_trainer(seed, monkeypatch):
    """The script's graph (captured at its init) is the twin's, its edit
    the twin's, then 3 steps of the fairness loss. At the default seed 0
    the edit leaves 3 nodes without an in-edge: their encodings are 0, the
    JAX unit rows' gradient there is NaN and the JAX loop's losses are NaN
    from its second step (ROADMAP C32); the twin's first loss is JAX's and
    its steps stay finite. At seed 3 every node keeps an in-edge and the 3
    losses agree."""
    jmod, jargs, targs = _flags("fatragnn")
    jargs.seed = targs.seed = seed
    xj, eij = _capture_init(monkeypatch, jmod, "FatraGNNModel", jargs)
    x, ei, y, sens, train_mask = fatragnn_trainer.fairness_graph(seed)
    np.testing.assert_array_equal(x, np.asarray(xj))
    np.testing.assert_array_equal(ei, np.asarray(eij))
    ei2 = jm.modify_structure(ei, ei, sens, drop=0.6)
    lonely = len(set(range(x.shape[0])) - set(ei2[1].tolist()))
    assert lonely == (3 if seed == 0 else 0)
    ei2 = jnp.asarray(ei2)
    model = jm.FatraGNNModel(num_features=x.shape[1],
                             hidden=jargs.hidden_dim)
    yj, tmj = jnp.asarray(y.astype(np.float32)), jnp.asarray(train_mask)

    def loss_of(p):
        logits = model.apply(p, xj, eij, 0)[:, 0]
        ce = jnp.where(tmj, optax.sigmoid_binary_cross_entropy(logits, yj),
                       0).sum() / tmj.sum()
        out = model.apply(p, xj, eij, 5, edge_index2=ei2)
        return ce + 0.5 * ((out["h1"] - out["h2"]) ** 2).sum(1).mean()

    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(seed), xj, eij,
                           method=jm.FatraGNNModel.init_all),
        loss_of, jargs.lr, [()] * STEPS)
    targs.n_epoch = STEPS
    out = fatragnn_trainer.main(targs, params=_np_tree(params))
    if seed == 0:
        assert np.isnan(want[1:]).all() and np.isfinite(out["losses"]).all()
        np.testing.assert_allclose(out["losses"][0], want[0], rtol=1e-5)
    else:
        _close(out, want)
    assert 0.0 <= out["test_acc"] <= 1.0 and 0.0 <= out["parity_gap"] <= 1


# -- every twin ------------------------------------------------------------

def _own_run(name, n_epoch):
    module = TWINS[name]
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch",
                                       str(n_epoch)])
    if name in OWN_DATA:
        return module.main(args)
    return module.main(args, data=_tiny_data(10))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_trains_on_the_cpu_with_its_own_draws(name, capsys):
    """The twin's own init and draws (dropout on where the model has it):
    the run ends, the losses are finite, the scores are fractions."""
    out = _own_run(name, 2)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
    for key in ("probe_acc", "auc", "best_test", "test_acc"):
        if key in out:
            assert 0.0 <= out[key] <= 1.0
    assert "cpu)" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_defaults_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    rather than falling back to the CPU."""
    module = TWINS[name]
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {} if name in OWN_DATA else {"data": _tiny_data(11)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]), **kw)
