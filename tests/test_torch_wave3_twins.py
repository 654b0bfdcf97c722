"""The sgformer, gnnlfhf, cagcn, merit, grade, tadw, graphormer and rgt
trainer twins (`gammagl_tpu_torch/examples/`) against the JAX trainers of
`examples/<name>/<name>_trainer.py`.

Each twin has the JAX script's flags and defaults (read from its
``__main__`` block by AST). Its loop, from the JAX init and with JAX's
draws handed in (the two-view masks) or dropout off, gives the JAX
trainer's first 3 losses at rtol 1e-5; the JAX loops are the scripts'
steps on the same data under one jit, on the data the scripts build
(captured from the JAX ``main`` where the script makes its own: the
graphormer graphs, the rgt init batch). `tadw`'s embeddings are held at
rtol 1e-4. No model here takes a plan in either package.
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
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402
from tests.test_torch_simple_twins import _tiny_data  # noqa: E402
from tests.test_torch_ssl_twins import (_device_graph, _jax_script,  # noqa
                                        _masks, _step_keys)
from tests.test_torch_wave5_8_twins import (_adam_losses,  # noqa: E402
                                            _capture_init)
from tests.test_torch_sampler import pin_jax_sampler_lib  # noqa: E402

from gammagl_tpu_torch.examples import (  # noqa: E402
    cagcn_trainer, gnnlfhf_trainer, grade_trainer, graphormer_trainer,
    merit_trainer, rgt_trainer, sgformer_trainer, tadw_trainer)

TWINS = {"sgformer": sgformer_trainer, "gnnlfhf": gnnlfhf_trainer,
         "cagcn": cagcn_trainer, "merit": merit_trainer,
         "grade": grade_trainer, "tadw": tadw_trainer,
         "graphormer": graphormer_trainer, "rgt": rgt_trainer}
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def jax_sampler_lib(tmp_path_factory):
    """The rgt script samples through the JAX package's C++ sampler:
    built for this module and pinned (ROADMAP C30)."""
    mp = pytest.MonkeyPatch()
    yield pin_jax_sampler_lib(tmp_path_factory.mktemp("jax_sampler"), mp)
    mp.undo()


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    monkeypatch.delenv("GGL_REFERENCE_ROOT", raising=False)


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


def _close(losses, want):
    assert np.isfinite(want).all()
    np.testing.assert_allclose(losses[:STEPS], want, rtol=1e-5)


def _data():
    data = _tiny_data(8)
    return data, _device_graph(data), int(data["y"].max()) + 1


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_flags_are_the_jax_scripts(name):
    _flags(name)


# -- run_simple_node_trainer: sgformer, gnnlfhf, cagcn --------------------

@pytest.mark.parametrize("name,variant", [("sgformer", None),
                                          ("gnnlfhf", "lf"),
                                          ("gnnlfhf", "hf"),
                                          ("cagcn", None)])
def test_simple_loop_twin_matches_the_jax_trainer(name, variant,
                                                  monkeypatch):
    """The model the JAX script builds (captured from its ``main``), its
    dropout off in both packages, 3 steps of `run_simple_node_trainer`'s
    loop (Adam with decayed weights, ``train=True``) from its init."""
    jmod, jargs, targs = _flags(name)
    if variant is not None:
        jargs.variant = targs.variant = variant
    data, d, n_class = _data()
    monkeypatch.setattr(jmod, "probe_num_classes", lambda args: n_class)
    monkeypatch.setattr(jmod, "run_simple_node_trainer",
                        lambda model, args, **kw: model)
    jargs.drop_rate = targs.drop_rate = 0.0  # both build with dropout off
    jmodel = jmod.main(jargs)
    assert jmodel.drop_rate == 0.0
    x, ei, key = d["x"], d["edge_index"], jax.random.PRNGKey(jargs.seed)
    want, params = _adam_losses(
        lambda: jmodel.init({"params": key, "dropout": key}, x, ei),
        lambda p: jax_loss(jmodel.apply(p, x, ei, train=True,
                                        rngs={"dropout": key}), d["y"],
                           d["train_mask"]),
        jargs.lr, [()] * STEPS, decay=jargs.l2_coef)
    targs.n_epoch = STEPS
    _close(TWINS[name].main(targs, data=data,
                            params=_np_tree(params))["losses"], want)


# -- run_two_view_ssl: merit, grade ---------------------------------------

@pytest.mark.parametrize("name", ["merit", "grade"])
def test_two_view_twin_matches_the_jax_trainer(name):
    """The JAX init of `run_two_view_ssl` (views of the seed key's
    halves), then 3 steps on the step keys' view masks, handed to both
    packages, with every self-loop kept (a node that loses all its
    in-edges has a zero row: C28). MERIT's loss keeps the target's
    gradient in both."""
    jmod, jargs, targs = _flags(name)
    de1, df1 = jargs.drop_edge_rate_1, jargs.drop_feature_rate_1
    de2, df2 = jargs.drop_edge_rate_2, jargs.drop_feature_rate_2
    data, d, _ = _data()
    x, ei = d["x"], d["edge_index"]
    n = x.shape[0]
    model = (jmod.Net(hidden_dim=jargs.hidden_dim) if name == "merit"
             else jm.GRADEModel(hidden_dim=jargs.hidden_dim))
    key = jax.random.PRNGKey(jargs.seed)
    k1, k2 = jax.random.split(key)
    xa, wa = jm.drop_edge_and_feature(k1, x, ei, de1, df1)
    xb, wb = jm.drop_edge_and_feature(k2, x, ei, de2, df2)
    masks = []
    for k in _step_keys(jargs.seed, STEPS):
        ka, kb = jax.random.split(k)
        m = tuple(_masks(kv, x, ei, a, b) for kv, a, b in (
            (ka, de1, df1), (kb, de2, df2)))
        m[0][1][-n:] = m[1][1][-n:] = True  # add_self_loops appends them
        masks.append(m)

    def loss_of(p, fa, ea, fb, eb):
        return model.apply(p, x * fa, ei, ea.astype(x.dtype), x * fb, ei,
                           eb.astype(x.dtype))

    want, params = _adam_losses(
        lambda: model.init(key, xa, ei, wa, xb, ei, wb), loss_of, jargs.lr,
        [(fa, ea, fb, eb) for (fa, ea), (fb, eb) in masks])
    draws = iter([tuple(tuple(torch.from_numpy(np.array(a)) for a in v)
                        for v in m) for m in masks])
    targs.n_epoch = STEPS
    out = TWINS[name].main(targs, data=data, params=_np_tree(params),
                           draws=draws)
    _close(out["losses"], want)
    assert 0.0 <= out["probe_acc"] <= 1.0


# -- tadw -----------------------------------------------------------------

@pytest.mark.parametrize("feat,steps", [(12, 1), (230, 1), (12, 20)])
def test_tadw_twin_matches_the_jax_trainer(feat, steps, monkeypatch):
    """The script's adjacency and text (an SVD to 200 dimensions where
    wider) and its draws, the embeddings at rtol 1e-4 after one step; the
    probe runs on them in both. At the script's 20 steps both diverge
    (ROADMAP C38): neither package's embeddings are finite."""
    jmod, jargs, targs = _flags("tadw")
    jargs.n_epoch = targs.n_epoch = steps
    data = _tiny_data(8)
    if feat != 12:
        rng = np.random.default_rng(1)
        data = dict(data, x=rng.normal(size=(60, feat)).astype(np.float32))
    n_class = int(data["y"].max()) + 1
    monkeypatch.setattr(jmod, "load_node_dataset", lambda *a: (JaxGraph(
        **data), n_class))
    seen = {}
    monkeypatch.setattr(jmod, "linear_probe", lambda emb, d, c: seen.update(
        emb=np.asarray(emb)) or 0.5)
    with np.errstate(all="ignore"):
        jmod.main(jargs)
    out = TWINS["tadw"].main(targs, data=data)
    assert out["embedding"].shape == (60, 2 * jargs.hidden_dim)
    if steps == 20:
        assert not np.isfinite(seen["emb"]).all()
        assert not np.isfinite(out["embedding"]).all()
        return
    assert np.isfinite(seen["emb"]).all()
    np.testing.assert_allclose(out["embedding"], seen["emb"], rtol=1e-4,
                               atol=1e-6)
    assert 0.0 <= out["probe_acc"] <= 1.0


# -- graphormer -----------------------------------------------------------

def test_graphormer_twin_matches_the_jax_trainer(monkeypatch):
    """The script's graphs (its init graph captured from ``main``) are
    the twin's; 3 steps of its loop, one graph a step."""
    jmod, jargs, targs = _flags("graphormer")
    captured = _capture_init(monkeypatch, jmod, "GraphormerModel", jargs)
    graphs = graphormer_trainer.graphs(jargs.seed, jargs.num_graphs)
    for a, b in zip(graphs[0][:4], captured):
        np.testing.assert_array_equal(a, np.asarray(b))
    model = jm.GraphormerModel(hidden_dim=jargs.hidden_dim, num_class=2,
                               num_layers=2, num_heads=2, dropout_rate=0.0)

    def loss_of(p, x, ind, outd, dist, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            model.apply(p, x, ind, outd, dist)[None], y[None]).mean()

    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), *captured),
        loss_of, jargs.lr,
        [tuple(jnp.asarray(a) for a in g) for g in graphs[:STEPS]])
    targs.n_epoch = 1
    out = graphormer_trainer.main(targs, params=_np_tree(params))
    _close(out["losses"], want)
    assert len(out["losses"]) == jargs.num_graphs


# -- rgt ------------------------------------------------------------------

def test_rgt_twin_matches_the_jax_trainer(monkeypatch):
    """The script's loader and init batch (captured from ``main``) are
    the twin's; 3 of its steps, one batch a step. The JAX steps take the
    batches' edges padded to one width with the out-of-range id, which
    its segment ops drop, so one compile serves the three."""
    jmod, jargs, targs = _flags("rgt")
    data, _, n_class = _data()
    monkeypatch.setattr(jmod, "load_node_dataset", lambda *a: (JaxGraph(
        **data), n_class))
    captured = _capture_init(monkeypatch, jmod, "RGTModel", jargs)
    batches = rgt_trainer.loader(data, targs)
    first = next(iter(batches))
    for a, b in zip(rgt_trainer.batch_args(first, "cpu"), captured):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    steps = list(batches)[:STEPS]
    width = max(b.edge_index.shape[1] for b in steps)

    def padded(b):
        ei = np.full((2, width), b.num_nodes, np.int64)
        ei[:, :b.edge_index.shape[1]] = b.edge_index
        return (jnp.asarray(b.x), jnp.asarray(ei),
                jnp.asarray(b.tree_edge_index),
                jnp.asarray(b.cycle_edge_index),
                jnp.asarray(b.seq_edge_index))

    seeds = first.num_seeds
    model = jm.RGTModel(in_dim=data["x"].shape[1],
                        hidden_dim=jargs.hidden_dim, embed_dim=32,
                        n_layers=2, codebook_size=64, codebook_dim=16,
                        codebook_heads=4)
    want, params = _adam_losses(
        lambda: model.init(jax.random.PRNGKey(jargs.seed), *captured,
                           method=jm.RGTModel.train_loss),
        lambda p, *b: model.apply(p, *b, seeds,
                                  method=jm.RGTModel.train_loss)[0],
        jargs.lr, [padded(b) for b in steps])
    out = rgt_trainer.main(targs, data=data, params=_np_tree(params),
                           max_steps=STEPS)
    _close(out["losses"], want)
    assert len(out["losses"]) == STEPS and 0.0 <= out["probe_acc"] <= 1.0
