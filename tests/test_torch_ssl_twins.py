"""The self-supervised and spectral trainer twins
(`gammagl_tpu_torch/examples/`: dgi, grace, mvgrl, ggd, infograph, vgae,
specformer, mgnni) against the JAX trainers of
`examples/<name>/<name>_trainer.py`.

Each twin has the JAX script's flags and defaults (read from its
``__main__`` block by AST: ``base_parser(...)`` and any
``add_argument``). Its loop, from the JAX init and with JAX's draws
handed in (the corruption permutations, the view masks, VGAE's noise;
dropout off), gives the JAX trainer's first 3 losses at rtol 1e-5; the
JAX loops are the scripts' steps on the same data under one jit. The
models take no plan in either package, so both sum on their COO ops.
"""

import ast
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
from gammagl_tpu.data import Graph as JaxGraph  # noqa: E402
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from gammagl_tpu.utils import calc_gcn_norm as jax_gcn_norm  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402
from tests.test_torch_simple_twins import _tiny_data  # noqa: E402
from tests.test_torch_ssl import _distinct_singular  # noqa: E402

from gammagl_tpu_torch.examples import (  # noqa: E402
    dgi_trainer, ggd_trainer, grace_trainer, infograph_trainer,
    mgnni_trainer, mvgrl_trainer, specformer_trainer, vgae_trainer)

TWINS = {"dgi": dgi_trainer, "grace": grace_trainer,
         "mvgrl": mvgrl_trainer, "ggd": ggd_trainer,
         "infograph": infograph_trainer, "vgae": vgae_trainer,
         "specformer": specformer_trainer, "mgnni": mgnni_trainer}
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
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")


def _jax_script(name):
    """The JAX trainer module and its command line's defaults: the
    ``base_parser(...)`` keywords and the ``add_argument`` calls of its
    source, read by AST."""
    import importlib
    path = osp.join(osp.dirname(__file__), "..", "examples", name,
                    f"{name}_trainer.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    overrides, extra = {}, {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "base_parser":
            overrides = {k.arg: ast.literal_eval(k.value)
                         for k in node.keywords}
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = ast.literal_eval(node.args[0]).lstrip("-")
            extra[flag] = {k.arg: k.value for k in node.keywords}
    parser = jax_common.base_parser(**overrides)
    for flag, kw in extra.items():
        parser.add_argument(f"--{flag}", type=eval(ast.unparse(kw["type"])),
                            default=ast.literal_eval(kw["default"]))
    module = importlib.import_module(f"examples.{name}.{name}_trainer")
    return module, parser.parse_args([])


def _flags(name):
    jmod, jargs = _jax_script(name)
    targs = TWINS[name].parser().parse_args(["--device", "cpu"])
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)
    return jmod, jargs, targs


def _device_graph(data):
    """The JAX examples' ``device_graph`` of numpy arrays."""
    n = data["x"].shape[0]
    ei, _ = jax_add_self_loops(data["edge_index"], num_nodes=n)
    return {"x": jnp.asarray(data["x"]), "edge_index": jnp.asarray(ei),
            "y": jnp.asarray(data["y"]),
            "train_mask": jnp.asarray(data["train_mask"])}


def _run(init, loss_of, lr, keys):
    """The model's init (``init()``) and Adam's state (``lr``) under one
    jit, then a step of ``loss_of(params, key)`` for each key under
    another: (the losses, the init tree)."""
    tx = optax.adam(lr)
    state = jax.jit(lambda: JaxTrainState.create(params=init(), tx=tx))()
    params = state.params

    @jax.jit
    def step(state, key):
        loss, grads = jax.value_and_grad(loss_of)(state.params, key)
        return state.apply_gradients(grads), loss

    losses = []
    for key in keys:
        state, loss = step(state, key)
        losses.append(float(loss))
    return losses, params


def _step_keys(seed, n):
    """The scripts' per-step keys: rng = PRNGKey(seed + 1); each step
    rng, k = split(rng)."""
    rng, keys = jax.random.PRNGKey(seed + 1), []
    for _ in range(n):
        rng, k = jax.random.split(rng)
        keys.append(k)
    return keys


def _masks(key, x, ei, a, b):
    """JAX's draws of ``drop_edge_and_feature(key, x, ei, a, b)``: the
    feature mask (rate a) and the edge mask (rate b)."""
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.bernoulli(k1, 1 - a, (1, x.shape[1]))),
            np.array(jax.random.bernoulli(k2, 1 - b, (ei.shape[1],))))


def _tensors(arrays):
    return iter([torch.from_numpy(np.asarray(a)) for a in arrays])


# -- the corruption family: DGI, GGD, MVGRL ------------------------------

@pytest.mark.parametrize("name", ["dgi", "ggd", "mvgrl"])
def test_corruption_twin_matches_the_jax_trainer(name):
    """The JAX scripts: init at PRNGKey(seed) on a corrupted x, then each
    step corrupts by ``permutation(k, n)`` of the step's key."""
    _, jargs, targs = _flags(name)
    data = _tiny_data(8)
    d = _device_graph(data)
    x, ei = d["x"], d["edge_index"]
    key = jax.random.PRNGKey(jargs.seed)
    if name == "mvgrl":
        model = jm.MVGRLModel(hidden_dim=jargs.hidden_dim)
        w = jax.jit(jax_gcn_norm, static_argnums=1)(ei, x.shape[0])
        views = (ei, w)
    else:
        model = (jm.DGIModel if name == "dgi" else jm.GGDModel)(
            hidden_dim=jargs.hidden_dim)
        views = ()
    n_draws = dgi_trainer.CHUNK if name == "dgi" else STEPS
    keys = _step_keys(jargs.seed, n_draws)
    want, params = _run(
        lambda: model.init(key, x, ei, *views, jm.corrupt_features(key, x)),
        lambda p, k: model.apply(p, x, ei, *views,
                                 jm.corrupt_features(k, x)),
        jargs.lr, keys[:STEPS])
    perms = jax.jit(jax.vmap(lambda k: jax.random.permutation(
        k, x.shape[0])))(jnp.stack(keys))
    targs.n_epoch = STEPS
    got = TWINS[name].main(targs, data=data, params=_np_tree(params),
                           draws=_tensors(perms))
    assert len(got["losses"]) == n_draws  # DGI: a whole chunk of 20
    np.testing.assert_allclose(got["losses"][:STEPS], want, rtol=1e-5)


# -- GRACE: two views ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _grace_jax():
    """The JAX GRACE model, its init by `run_two_view_ssl` (key
    PRNGKey(seed) split for the init's views; the tree depends on the
    shapes only, not on the rates) and the loop's Adam step with the
    views' masks as arguments, compiled once for the module."""
    _, jargs, _ = _flags("grace")
    data = _tiny_data(8)
    d = _device_graph(data)
    x, ei = d["x"], d["edge_index"]
    model = jm.GraceModel(hidden_dim=jargs.hidden_dim,
                          proj_dim=jargs.hidden_dim, tau=0.5)

    tx = optax.adam(jargs.lr)

    @jax.jit
    def init(key):
        k1, k2 = jax.random.split(key)
        x1, w1 = jm.drop_edge_and_feature(k1, x, ei, 0.2, 0.2)
        x2, w2 = jm.drop_edge_and_feature(k2, x, ei, 0.2, 0.2)
        return JaxTrainState.create(
            params=model.init(key, x1, ei, w1, x2, ei, w2), tx=tx)

    state = init(jax.random.PRNGKey(jargs.seed))

    @jax.jit
    def step(state, m):
        (fa, ea), (fb, eb) = m
        loss, grads = jax.value_and_grad(lambda p: model.apply(
            p, x * fa, ei, ea.astype(x.dtype), x * fb, ei,
            eb.astype(x.dtype)))(state.params)
        return state.apply_gradients(grads), loss

    return data, x, ei, state.params, state, step


def _grace_setup(rates):
    """The step keys' view masks (each step's key split in two, view v
    drawn by ``drop_edge_and_feature(k_v, x, ei, edge_rate_v,
    feature_rate_v)``: C27, the edge rate goes to the feature mask), the
    JAX loop's losses and the twin's for given masks."""
    _, jargs, targs = _flags("grace")
    if rates is not None:
        for args in (jargs, targs):
            (args.drop_edge_rate_1, args.drop_feature_rate_1,
             args.drop_edge_rate_2, args.drop_feature_rate_2) = rates
    de1, df1 = jargs.drop_edge_rate_1, jargs.drop_feature_rate_1
    de2, df2 = jargs.drop_edge_rate_2, jargs.drop_feature_rate_2
    data, x, ei, params, state0, step = _grace_jax()
    masks = []
    for k in _step_keys(jargs.seed, STEPS):
        ka, kb = jax.random.split(k)
        masks.append(tuple(_masks(kv, x, ei, a, b) for kv, a, b in (
            (ka, de1, df1), (kb, de2, df2))))
    targs.n_epoch = STEPS

    def jax_losses(masks):
        state, losses = state0, []
        for m in masks:
            state, loss = step(state, m)
            losses.append(float(loss))
        return losses

    def twin(masks):
        draws = iter([tuple(tuple(torch.from_numpy(np.array(a)) for a in v)
                            for v in m) for m in masks])
        return grace_trainer.main(targs, data=data, params=_np_tree(params),
                                  draws=draws)["losses"]
    return masks, jax_losses, twin, data["x"].shape[0]


@pytest.mark.parametrize("rates", [None, (0.4, 0.1, 0.3, 0.05)])
def test_grace_twin_matches_the_jax_trainer(rates):
    """3 steps of the JAX loop, the step keys' masks handed to both
    packages, with every self-loop kept (so no node loses all its
    in-edges: there JAX's gradient is NaN, C28, the next test). Unequal
    rates show the C27 swap in both packages alike."""
    masks, jax_losses, twin, n = _grace_setup(rates)
    for (_, ea), (_, eb) in masks:
        ea[-n:] = eb[-n:] = True  # add_self_loops appends the loops
    np.testing.assert_allclose(twin(masks), jax_losses(masks), rtol=1e-5)


def test_grace_twin_is_finite_where_jax_turns_nan():
    """ROADMAP C28 in the loop: with the step keys' own masks a node of
    the tiny graph loses every in-edge, its rows are exactly 0, JAX's
    gradients are NaN and its loss is NaN from step 2; the twin's first
    loss is JAX's and its steps stay finite."""
    masks, jax_losses, twin, _ = _grace_setup(None)
    want, got = jax_losses(masks), twin(masks)
    assert np.isnan(want[1:]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert np.isfinite(got).all()


class _Stub:
    """A model for JAX's two-view loop whose loss reads the views and
    nothing else: the loop's own calls are what the test records."""

    def init(self, key, *views):
        return {"params": {"w": jnp.zeros(())}}

    def apply(self, p, xa, ea, wa, xb, eb, wb):
        return p["params"]["w"] * (xa.sum() + wa.sum() + xb.sum() + wb.sum())


def test_two_view_loop_swaps_the_rates_as_jax_does(monkeypatch):
    """ROADMAP C27. Both packages' `run_two_view_ssl` call
    ``drop_edge_and_feature`` with (edge rate, feature rate) in the
    places of (feat_drop, edge_drop): with unequal rates the feature mask
    gets the edge rate. Recorded from each package's own loop."""
    seen = {"jax": [], "port": []}
    real_j = jm.drop_edge_and_feature

    def rec_j(rng, x, ei, feat_drop, edge_drop):
        seen["jax"].append((feat_drop, edge_drop))
        return real_j(rng, x, ei, feat_drop, edge_drop)

    import gammagl_tpu_torch.models as tm
    real_tm = tm.drop_edge_and_feature

    def rec_t(x, ei, feat_drop, edge_drop, *rest):
        seen["port"].append((feat_drop, edge_drop))
        return real_tm(x, ei, feat_drop, edge_drop, *rest)

    monkeypatch.setattr(jm, "drop_edge_and_feature", rec_j)
    monkeypatch.setattr(tm, "drop_edge_and_feature", rec_t)
    data = _tiny_data(8)
    g = JaxGraph(**{k: data[k] for k in ("x", "edge_index", "y",
                                         "train_mask", "val_mask",
                                         "test_mask")})
    monkeypatch.setattr(jax_common, "load_node_dataset",
                        lambda name, path: (g, 4))
    from gammagl_tpu_torch.examples import common as port_common
    for mod in (jax_common, port_common):  # the rates only: no probe
        monkeypatch.setattr(mod, "linear_probe", lambda *a, **k: 0.0)
    _, jargs, targs = _flags("grace")
    for args in (jargs, targs):
        args.n_epoch = 1
        args.drop_edge_rate_1, args.drop_feature_rate_1 = 0.4, 0.1
        args.drop_edge_rate_2, args.drop_feature_rate_2 = 0.3, 0.05
    jax_common.run_two_view_ssl(_Stub(), jargs,
                                embed_fn=lambda m, p, x, ei: x)
    grace_trainer.main(targs, data=data)
    want = [(0.4, 0.1), (0.3, 0.05)]
    assert seen["jax"] == want * 2  # the init's views, then the step's
    assert seen["port"] == want


def test_grace_view_masks_take_the_swapped_rates():
    """Drawn by the port itself (no draws handed in): over many columns
    the first view's feature mask keeps 1 - edge rate of them."""
    x = torch.ones(4, 20000)
    ei = torch.zeros(2, 20000, dtype=torch.long)
    gen = torch.Generator().manual_seed(0)
    from gammagl_tpu_torch.models import drop_edge_and_feature
    xa, wa = drop_edge_and_feature(x, ei, 0.4, 0.1, gen)  # the loop's call
    assert abs(float((xa[0] != 0).float().mean()) - 0.6) < 0.02
    assert abs(float(wa.mean()) - 0.9) < 0.02


# -- InfoGraph -----------------------------------------------------------

class _Captured(Exception):
    pass


def test_infograph_twin_matches_the_jax_trainer(monkeypatch):
    """The JAX script's batch (captured at its model's init) is the
    twin's `graph_batch`, and 3 steps from the JAX init give its
    losses."""
    jmod, jargs, targs = _flags("infograph")
    seen = {}

    class Capture(jm.InfoGraph):
        def init(self, rngs, *args):
            seen["model"], seen["args"] = self, args
            raise _Captured

    monkeypatch.setattr(jmod, "InfoGraph", Capture)
    with pytest.raises(_Captured):
        jmod.main(jargs)
    x, ei, batch, num_graphs = seen["args"]
    data = infograph_trainer.graph_batch(targs.seed)
    for got, want in zip(data[:3], (x, ei, batch)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert len(data[3]) == num_graphs
    model = jm.InfoGraph(hidden_dim=jargs.hidden_dim, num_layers=2)
    want, params = _run(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), x, ei, batch,
                           num_graphs),
        lambda p, k: model.apply(p, x, ei, batch, num_graphs)[0], jargs.lr,
        [None] * STEPS)
    targs.n_epoch = STEPS
    got = infograph_trainer.main(targs, data=data, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


# -- VGAE ----------------------------------------------------------------

def test_vgae_twin_matches_the_jax_trainer(monkeypatch):
    """The JAX script's split and negatives (its `RandomLinkSplit` and
    `negative_sampling` under ``--seed``) are the twin's, and 3 steps
    from the JAX init with the noise of each step's key give its
    losses."""
    jmod, jargs, targs = _flags("vgae")
    data = _tiny_data(8)
    g = JaxGraph(**{k: data[k] for k in ("x", "edge_index", "y",
                                         "train_mask", "val_mask",
                                         "test_mask")})
    jtrain, _, jtest = jmod.RandomLinkSplit(
        num_val=0.05, num_test=0.1, is_undirected=False,
        seed=jargs.seed)(g.numpy())
    ttrain, _, ttest, neg = vgae_trainer.link_split(data, targs.seed)
    for a, b in ((ttrain.edge_index, jtrain.edge_index),
                 (ttest.edge_label_index, jtest.edge_label_index),
                 (ttest.edge_label, jtest.edge_label)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    n = data["x"].shape[0]
    ei = jnp.asarray(jtrain.edge_index)
    jneg = jmod.negative_sampling(np.asarray(jtrain.edge_index),
                                  num_nodes=n, num_neg_samples=ei.shape[1],
                                  rng=np.random.default_rng(jargs.seed))
    np.testing.assert_array_equal(neg, jneg)
    x = jnp.asarray(data["x"])
    model = jm.VGAEModel(hidden_dim=jargs.hidden_dim, latent_dim=16)

    def loss_of(p, k):
        mu, logstd, z = model.apply(p, x, ei, rng=k)
        return (jm.recon_loss(z, ei, jneg)
                + (1.0 / n) * jm.VGAEModel.kl_loss(mu, logstd))

    keys = _step_keys(jargs.seed, STEPS)
    want, params = _run(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), x, ei), loss_of,
        jargs.lr, keys)
    noise = jax.jit(jax.vmap(lambda k: jax.random.normal(k, (n, 16))))(
        jnp.stack(keys))
    targs.n_epoch = STEPS
    got = vgae_trainer.main(targs, data=data, params=_np_tree(params),
                            draws=_tensors(noise))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    assert 0.0 <= got["auc"] <= 1.0


# -- Specformer and MGNNI ------------------------------------------------

def test_specformer_twin_matches_the_jax_trainer():
    """The full ``eigh`` of the self-looped graph, then 3 steps of the
    JAX script's loop (dropout off) from its init."""
    jmod, jargs, targs = _flags("specformer")
    jargs.drop_rate = targs.drop_rate = 0.0
    data = _tiny_data(8)
    d = _device_graph(data)
    lam, u = jm.laplacian_eigh(np.asarray(d["edge_index"]),
                               data["x"].shape[0])
    model = jm.SpecformerModel(num_class=int(data["y"].max()) + 1,
                               hidden_dim=jargs.hidden_dim, num_filters=2,
                               drop_rate=jargs.drop_rate)
    key = jax.random.PRNGKey(jargs.seed)
    want, params = _run(
        lambda: model.init({"params": key, "dropout": key}, d["x"], lam, u),
        lambda p, k: jax_loss(model.apply(
            p, d["x"], lam, u, train=True, rngs={"dropout": k}), d["y"],
            d["train_mask"]), jargs.lr, _step_keys(jargs.seed, STEPS))
    targs.n_epoch = STEPS
    got = specformer_trainer.main(targs, data=data, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


def test_mgnni_twin_matches_the_jax_trainer(monkeypatch):
    """The model the JAX script builds (captured from its ``main``), 3
    steps of `run_simple_node_trainer`'s loop (Adam with decayed weights)
    from its init, each ``w_m`` at distinct singular values (ROADMAP
    C29: at the orthogonal init the spectral norm's gradient has no one
    value)."""
    jmod, jargs, targs = _flags("mgnni")
    data = _tiny_data(8)
    monkeypatch.setattr(jmod, "probe_num_classes",
                        lambda args: int(data["y"].max()) + 1)
    monkeypatch.setattr(jmod, "run_simple_node_trainer",
                        lambda model, args, **kw: model)
    model = jmod.main(jargs)
    d = _device_graph(data)
    key = jax.random.PRNGKey(jargs.seed)
    params = _distinct_singular(jax.jit(model.init)(
        {"params": key, "dropout": key}, d["x"], d["edge_index"]))
    tx = optax.chain(optax.add_decayed_weights(jargs.l2_coef),
                     optax.adam(jargs.lr))
    state = jax.jit(lambda p: JaxTrainState.create(params=p, tx=tx))(params)

    @jax.jit
    def step(state):
        loss, grads = jax.value_and_grad(lambda p: jax_loss(model.apply(
            p, d["x"], d["edge_index"], train=True), d["y"],
            d["train_mask"]))(state.params)
        return state.apply_gradients(grads), loss

    want = []
    for _ in range(STEPS):
        state, loss = step(state)
        want.append(float(loss))
    targs.n_epoch = STEPS
    got = mgnni_trainer.main(targs, data=data, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


# -- every twin ----------------------------------------------------------

def _own_run(name, n_epoch):
    module = TWINS[name]
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch",
                                       str(n_epoch)])
    return module.main(args) if name == "infograph" else \
        module.main(args, data=_tiny_data(10))


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_trains_on_the_cpu_with_its_own_draws(name):
    """The twin's own init and draws (dropout on where the model has it):
    the run ends, the losses are finite, the scores are fractions."""
    out = _own_run(name, 2)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) >= 2
    score = out.get("probe_acc", out.get("auc", out.get("best_test")))
    assert 0.0 <= score <= 1.0


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_defaults_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    rather than falling back to the CPU."""
    module = TWINS[name]
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = {} if name == "infograph" else {"data": _tiny_data(11)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]), **kw)
