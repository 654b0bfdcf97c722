"""The port's RGCNConv, HANConv, SimpleHGNConv, their models and the
rgcn, han and simplehgn trainer twins against the JAX package.

Each test hands both packages the same parameters (a JAX init carried
across with `load_jax_params`) and the same edges, on the COO route (no
plan) and on the plan route (the port's `CSRPlan`, whose kernels run
their plain versions here; the JAX layers' Pallas plan path runs in
interpret mode). The JAX HAN layer's plan path raises on a relation whose
source type has more rows than its padded destination rows (ROADMAP C14):
the port's plan route is held against the JAX COO route there, which is
the function the JAX trainer computes (it never passes plans).

Each JAX reference is one jitted function (the forward and its gradients
under one compile), and a reference that several cases share (the COO
route's, held against both of the port's routes) is computed once a
module.

Tolerances, relative to max |out| (max |grad| for gradients), float32:
1e-5 against the XLA (COO) path, 1e-4 against the Pallas path (bf16x3
products that drop the lo*lo term). Train-mode dropout cannot be matched
across the packages (the masks come from different generators), so the
twins are held against the JAX trainers with dropout off, and the port's
own train-mode routes against each other.
"""

import argparse
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
import gammagl_tpu.datasets as jax_datasets  # noqa: E402
from examples.common import (  # noqa: E402
    synthetic_hetero as jax_synthetic_hetero)
from examples.han import han_trainer as jax_han  # noqa: E402
from examples.rgcn import rgcn_trainer as jax_rgcn  # noqa: E402
from examples.simplehgn import simplehgn_trainer as jax_simplehgn  # noqa: E402
from gammagl_tpu.layers.conv import HANConv as JaxHANConv  # noqa: E402
from gammagl_tpu.layers.conv import RGCNConv as JaxRGCNConv  # noqa: E402
from gammagl_tpu.layers.conv import (  # noqa: E402
    SimpleHGNConv as JaxSimpleHGNConv)
from gammagl_tpu.models import HANModel as JaxHANModel  # noqa: E402
from gammagl_tpu.models import RGCNModel as JaxRGCNModel  # noqa: E402
from gammagl_tpu.models import (  # noqa: E402
    SimpleHGNModel as JaxSimpleHGNModel)
from gammagl_tpu.ops.pallas import (  # noqa: E402
    build_csr_plan as jax_build_csr_plan)
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402
from tests.test_torch_simple_convs import _jax_out_and_grads  # noqa: E402

from gammagl_tpu_torch.examples import (common, han_trainer,  # noqa: E402
                                        rgcn_trainer, simplehgn_trainer)
from gammagl_tpu_torch.layers.conv import (HANConv, RGCNConv,  # noqa: E402
                                           SimpleHGNConv)
from gammagl_tpu_torch.models import (HANModel, RGCNModel,  # noqa: E402
                                      SimpleHGNModel)
from gammagl_tpu_torch.ops.cuda import build_csr_plan  # noqa: E402
from gammagl_tpu_torch.train import semi_supervised_loss  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

ROUTES = ["coo", "plan"]
TWINS = {"rgcn": rgcn_trainer, "han": han_trainer,
         "simplehgn": simplehgn_trainer}


def _check(got, want, tol):
    """|got - want| <= tol * max |want|, elementwise."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _port_grads(module):
    """The port's gradients under flax names (kernels transposed back);
    a parameter the loss does not reach gives zeros, as in JAX."""
    out = {}

    def grad(p):
        return np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.detach().numpy()

    def visit(m, prefix):
        for name, child in m.flax_tree().items():
            if isinstance(child, torch.nn.Linear):
                out[f"{prefix}{name}/kernel"] = grad(child.weight).T
                if child.bias is not None:
                    out[f"{prefix}{name}/bias"] = grad(child.bias)
            elif isinstance(child, torch.nn.Module):
                visit(child, f"{prefix}{name}/")
            else:
                out[f"{prefix}{name}"] = grad(child)
    visit(module, "")
    return out


def _check_grads(module, jax_grads, tol):
    want = dict(_flat(jax_grads["params"]))
    got = _port_grads(module)
    assert sorted(got) == sorted(want)
    for name in want:
        _check(got[name], want[name], tol)


def _typed_edges(seed, n=40, e=220, R=3):
    """One node set with typed edges; nodes 30.. receive no edge."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n - 10, e)])
    return ei, rng.integers(0, R, e), n, R


RGCN_FORMS = {"bases": {"num_bases": 2}, "blocks": {"num_blocks": 2},
              "full": {}}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("form", sorted(RGCN_FORMS))
def test_rgcn_conv_matches_jax(form, route):
    """Forward and the gradients of sum(out * g) in the parameters, each
    weight form, on the COO route and on the plan route (JAX's plan path
    sums in its Pallas segment kernel; the port's is `segment_sum_csr`)."""
    ei, et, n, R = _typed_edges(1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    g = rng.normal(size=(n, 6)).astype(np.float32)
    kw = RGCN_FORMS[form]
    jconv = JaxRGCNConv(8, 6, R, **kw)
    jx, jei, jet = jnp.asarray(x), jnp.asarray(ei), jnp.asarray(et)
    params = _np_tree(jconv.init(jax.random.PRNGKey(3), jx, jei, jet))
    jplan = (jax_build_csr_plan(ei[0], ei[1], n, R=8, ET=32)
             if route == "plan" else None)
    want, grads = _jax_out_and_grads(
        lambda p: jconv.apply(p, jx, jei, jet, plan=jplan),
        lambda out: (out * jnp.asarray(g)).sum(), params)
    conv = load_jax_params(RGCNConv(8, 6, R, **kw), params)
    plan = build_csr_plan(ei[0], ei[1], n) if route == "plan" else None
    got = conv(torch.tensor(x), torch.tensor(ei), torch.tensor(et),
               plan=plan)
    tol = 1e-5 if route == "coo" else 1e-4
    _check(got, want, tol)
    (got * torch.tensor(g)).sum().backward()
    _check_grads(conv, grads, tol)


def test_rgcn_conv_checks_its_blocks():
    with pytest.raises(ValueError, match="blocks do not divide"):
        RGCNConv(8, 6, 3, num_blocks=4)
    conv = RGCNConv(8, 6, 3, root_weight=False, add_bias=False)
    assert sorted(conv.flax_tree()) == ["weight"]


def _graphs(seed=0):
    """The JAX trainers' synthetic typed graph, from both packages."""
    jhg, target = jax_synthetic_hetero(seed)
    hg, target2 = common.synthetic_hetero(seed)
    assert target == target2 == "movie"
    x_dict = {nt: np.asarray(x, np.float32) for nt, x in hg.x_dict.items()}
    return jhg, hg, x_dict, dict(hg.edge_index_dict)


def _tensors(x_dict, ei_dict):
    return ({k: torch.tensor(v) for k, v in x_dict.items()},
            {k: torch.tensor(v) for k, v in ei_dict.items()})


@functools.lru_cache(maxsize=None)
def _han_conv_reference():
    """The JAX HANConv's parameters and its COO output on the typed
    graph, once a module."""
    jhg, hg, x_dict, ei_dict = _graphs()
    jconv = JaxHANConv(out_channels=4, metadata=jhg.metadata(), heads=2)
    jx = {k: jnp.asarray(v) for k, v in x_dict.items()}
    jei = {k: jnp.asarray(v) for k, v in ei_dict.items()}
    params = _np_tree(jax.jit(jconv.init)(jax.random.PRNGKey(5), jx, jei))
    want = jax.jit(lambda p: jconv.apply(p, jx, jei))(params)
    return hg, x_dict, ei_dict, params, want


@pytest.mark.parametrize("route", ROUTES)
def test_han_conv_matches_the_jax_coo_route(route):
    """Every relation of the typed graph (two cross-type, one same-type):
    the port's COO route and its plan route (one CSRPlan a relation)
    against the JAX layer's COO route, the function the JAX trainer
    computes."""
    hg, x_dict, ei_dict, params, want = _han_conv_reference()
    conv = load_jax_params(HANConv(32, 4, hg.metadata(), heads=2), params)
    got = conv(*_tensors(x_dict, ei_dict),
               plan_dict=hg.csr_plans() if route == "plan" else None)
    assert sorted(got) == sorted(want) == ["director", "movie"]
    for nt in want:
        _check(got[nt], want[nt], 1e-5)


def test_cross_type_relation_plan_route_gives_the_jax_coo_function_c14():
    """ROADMAP C14. On movie -> director (200 movie rows, 60 directors)
    the JAX plan path raises: its GATConv scores destinations from the
    source rows, and 200 rows do not broadcast into the 64 padded
    destination rows. The port's plan route gives the JAX COO function
    there, in forward and in the gradients, reading the source scores at
    min(d, 199) and nothing past the end; on director -> movie (60 source
    rows, 200 destinations) both packages' plan routes give it, and on
    the same-type relation the JAX plan path is held at 1e-4."""
    jhg, hg, x_dict, ei_dict = _graphs()
    jx = {k: jnp.asarray(v) for k, v in x_dict.items()}
    jei = {k: jnp.asarray(v) for k, v in ei_dict.items()}
    jplans = jhg.csr_plans()
    for et in hg.edge_types:
        meta = (hg.node_types, [et])
        jconv = JaxHANConv(out_channels=4, metadata=meta, heads=2)
        params = _np_tree(jconv.init(jax.random.PRNGKey(6), jx, jei))
        dst_t = et[2]
        g = np.random.default_rng(7).normal(
            size=(x_dict[dst_t].shape[0], 8)).astype(np.float32)

        coo, coo_grads = _jax_out_and_grads(
            lambda p: jconv.apply(p, jx, jei)[dst_t],
            lambda out: (out * jnp.asarray(g)).sum(), params)
        conv = load_jax_params(HANConv(32, 4, meta, heads=2), params)
        got = conv(*_tensors(x_dict, ei_dict), plan_dict=hg.csr_plans())
        (got[dst_t] * torch.tensor(g)).sum().backward()
        if et == ("movie", "by", "director"):
            with pytest.raises(ValueError, match="broadcast"):
                jconv.apply(params, jx, jei, plan_dict=jplans)
        else:
            _check(got[dst_t], jconv.apply(params, jx, jei,
                                           plan_dict=jplans)[dst_t], 1e-4)
        _check(got[dst_t], coo, 1e-5)
        _check_grads(conv, coo_grads, 1e-5)


def _flat_typed(seed=0):
    data = simplehgn_trainer.typed_graph(common.synthetic_hetero(seed)[0])
    return data, data["x"].shape[0]


class _Lanes:
    """Per-edge tensors between the caller's order, the port's CSR order
    and the JAX plan's padded lane order."""

    def __init__(self, ei, n):
        self.E = ei.shape[1]
        self.jplan = jax_build_csr_plan(ei[0], ei[1], n, R=8, ET=32)
        self.plan = build_csr_plan(ei[0], ei[1], n)

    def to_lanes(self, vc):
        valid = self.jplan.valid
        out = np.zeros((len(valid),) + vc.shape[1:], np.float32)
        out[valid] = vc[self.jplan.perm[valid]]
        return jnp.asarray(out)

    def from_lanes(self, v):
        v, valid = np.asarray(v, np.float32), self.jplan.valid
        out = np.zeros((self.E,) + v.shape[1:], np.float32)
        out[self.jplan.perm[valid]] = v[valid]
        return out

    def to_csr(self, vc):
        return torch.tensor(np.asarray(vc, np.float32)[self.plan.perm])

    def from_csr(self, v):
        out = np.zeros(v.shape, np.float32)
        out[self.plan.perm] = v.detach().numpy()
        return out


@pytest.mark.parametrize("route", ROUTES)
def test_simplehgn_conv_matches_jax(route):
    """Output, attention weights and the gradients of a loss on both,
    with ``alpha_prev``, on the flattened typed graph; alpha is compared
    in the caller's edge order."""
    data, n = _flat_typed()
    ei, et, x = data["edge_index"], data["edge_type"], data["x"]
    rng = np.random.default_rng(8)
    prev = rng.random((ei.shape[1], 2)).astype(np.float32)
    g_out = rng.normal(size=(n, 8)).astype(np.float32)
    g_alpha = rng.normal(size=prev.shape).astype(np.float32)
    jconv = JaxSimpleHGNConv(out_channels=4, num_etypes=3, heads=2)
    jx, jei, jet = jnp.asarray(x), jnp.asarray(ei), jnp.asarray(et)
    params = _np_tree(jconv.init(jax.random.PRNGKey(9), jx, jei, jet))
    lanes = _Lanes(ei, n)
    if route == "plan":
        jprev, jplan, jg_alpha = (lanes.to_lanes(prev), lanes.jplan,
                                  lanes.to_lanes(g_alpha))
        tprev, plan = lanes.to_csr(prev), lanes.plan
    else:
        jprev, jplan, jg_alpha = jnp.asarray(prev), None, jnp.asarray(g_alpha)
        tprev, plan = torch.tensor(prev), None

    (want_out, want_alpha), grads = _jax_out_and_grads(
        lambda p: jconv.apply(p, jx, jei, jet, alpha_prev=jprev,
                              plan=jplan),
        lambda oa: ((oa[0] * jnp.asarray(g_out)).sum()
                    + (oa[1] * jg_alpha).sum()), params)
    conv = load_jax_params(SimpleHGNConv(32, 4, 3, heads=2), params)
    out, alpha = conv(torch.tensor(x), torch.tensor(ei), torch.tensor(et),
                      alpha_prev=tprev, plan=plan)
    tg_alpha = (lanes.to_csr(g_alpha) if route == "plan"
                else torch.tensor(g_alpha))
    ((out * torch.tensor(g_out)).sum() + (alpha * tg_alpha).sum()).backward()
    tol = 1e-5 if route == "coo" else 1e-4
    _check(out, want_out, tol)
    if route == "plan":
        _check(lanes.from_csr(alpha), lanes.from_lanes(want_alpha), tol)
    else:
        _check(alpha, want_alpha, tol)
    _check_grads(conv, grads, tol)


def _model_case(name, route):
    """(JAX model, its params, apply(p) -> logits, port model, forward()
    -> logits) on the model's graph, with or without plans."""
    if name == "han":
        jhg, hg, x_dict, ei_dict = _graphs(1)
        jmodel = JaxHANModel(jhg.metadata(), 4, 3, "movie", heads=2)
        jx = {k: jnp.asarray(v) for k, v in x_dict.items()}
        jei = {k: jnp.asarray(v) for k, v in ei_dict.items()}
        params = _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(10), jx, jei))
        model = HANModel(hg.metadata(), 4, 3, "movie", heads=2,
                         in_channels=32)
        tx, tei = _tensors(x_dict, ei_dict)
        plans = hg.csr_plans() if route == "plan" else None
        return (jmodel, params, lambda p: jmodel.apply(p, jx, jei), model,
                lambda: model(tx, tei, plan_dict=plans))
    if name == "rgcn":
        ei, et, n, R = _typed_edges(11)
        x = np.random.default_rng(12).normal(size=(n, 8)).astype(np.float32)
        jmodel = JaxRGCNModel(8, 6, 3, R, num_bases=2)
        model = RGCNModel(8, 6, 3, R, num_bases=2)
    else:
        data, n = _flat_typed(2)
        ei, et, x = data["edge_index"], data["edge_type"], data["x"]
        jmodel = JaxSimpleHGNModel(3, 4, 3, heads=2)
        model = SimpleHGNModel(3, 4, 3, heads=2, in_channels=32)
    jx, jei, jet = jnp.asarray(x), jnp.asarray(ei), jnp.asarray(et)
    params = _np_tree(jax.jit(jmodel.init)({"params": jax.random.PRNGKey(13),
                                   "dropout": jax.random.PRNGKey(14)},
                                  jx, jei, jet))
    plan = build_csr_plan(ei[0], ei[1], n) if route == "plan" else None
    tx, tei, tet = torch.tensor(x), torch.tensor(ei), torch.tensor(et)
    return (jmodel, params, lambda p: jmodel.apply(p, jx, jei, jet), model,
            lambda: model(tx, tei, tet, plan=plan))


@functools.lru_cache(maxsize=None)
def _model_reference(name):
    """The JAX model's COO logits, labels and mask for them, and the
    gradients of their masked cross-entropy, once a module."""
    _, params, apply, _, _ = _model_case(name, "coo")
    rows = jax.eval_shape(apply, params).shape[0]
    y = np.random.default_rng(15).integers(0, 3, rows)
    mask = np.random.default_rng(16).random(rows) < 0.6
    logits, grads = _jax_out_and_grads(
        apply, lambda out: jax_loss(out, jnp.asarray(y), jnp.asarray(mask)),
        params)
    return logits, grads, y, mask


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["han", "rgcn", "simplehgn"])
def test_models_match_jax_with_its_params(name, route):
    """Each model loaded from the JAX model's flax tree (``RGCNConv_{i}``,
    ``HANConv_0``, ``SimpleHGNConv_{i}``, ``Dense_0``): eval-mode logits
    and the gradients of their masked cross-entropy (the port's plan
    route against the JAX COO route: JAX's models run their plan paths
    only through a trainer on a TPU)."""
    jmodel, params, apply, model, forward = _model_case(name, route)
    logits, grads, y, mask = _model_reference(name)
    load_jax_params(model, params).eval()
    got = forward()
    _check(got, logits, 1e-5)
    semi_supervised_loss(got, torch.tensor(y), torch.tensor(mask)).backward()
    _check_grads(model, grads, 1e-5)


@pytest.mark.parametrize("name", ["han", "simplehgn"])
def test_train_mode_plan_route_matches_the_coo_route(name):
    """Attention dropout in training mode: the masks are drawn from one
    generator state on both routes (HAN's GATs in the caller's edge
    order, SimpleHGN in CSR order, scattered into edge order on the COO
    route), so outputs and gradients agree."""
    results = []
    for route in ROUTES:
        torch.manual_seed(17)
        if name == "han":
            _, hg, x_dict, ei_dict = _graphs(2)
            model = HANModel(hg.metadata(), 4, 3, "movie", heads=2,
                             drop_rate=0.4, in_channels=32).train()
            tx, tei = _tensors(x_dict, ei_dict)
            plans = hg.csr_plans() if route == "plan" else None
            logits = model(tx, tei, plan_dict=plans,
                           generator=torch.Generator().manual_seed(18))
        else:
            data, n = _flat_typed(3)
            model = SimpleHGNModel(3, 4, 3, heads=2, drop_rate=0.4,
                                   in_channels=32).train()
            ei = data["edge_index"]
            plan = build_csr_plan(ei[0], ei[1], n) if route == "plan" \
                else None
            logits = model(torch.tensor(data["x"]), torch.tensor(ei),
                           torch.tensor(data["edge_type"]), plan=plan,
                           generator=torch.Generator().manual_seed(18))
        logits.square().sum().backward()
        results.append((logits, [p.grad for p in model.parameters()]))
    (lp, gp), (lc, gc) = results
    _check(lp, lc.detach(), 1e-5)
    # a gradient that is zero by the math (HAN's attention on director ->
    # movie, where every movie has one director: a softmax over one edge)
    # is rounding noise on one route and 0 on the other; hold each
    # gradient at 1e-5 of the model's largest
    scale = max(float(b.abs().max()) for b in gc if b is not None)
    for a, b in zip(gp, gc):
        if b is None:  # unreached by the loss on both routes
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-5 * scale)


def _jax_steps(loss_fn, params, lr, n):
    """n steps of the JAX trainers' Adam on ``loss_fn(params)``."""
    state = JaxTrainState.create(params=params, tx=optax.adam(lr))
    step = jax.jit(lambda s: (lambda loss, g: (s.apply_gradients(g), loss))(
        *jax.value_and_grad(loss_fn)(s.params)))
    losses = []
    for _ in range(n):
        state, loss = step(state)
        losses.append(float(loss))
    return losses


def _no_dataset(*args, **kwargs):
    raise OSError("no dataset files in the tree")


def test_rgcn_twin_matches_the_jax_trainer(monkeypatch):
    """The twin's synthetic knowledge graph is the JAX trainer's fallback
    (its Entities loader made to fail, so nothing is fetched), and 5
    steps of its loop give the JAX trainer's losses."""
    monkeypatch.setattr(jax_datasets, "Entities", _no_dataset)
    args = argparse.Namespace(dataset="aifb", dataset_path="data")
    g, num_rel = jax_rgcn.load(args)
    data = rgcn_trainer.synthetic_kg()
    assert num_rel == data["num_relations"] == 8
    for k in ("edge_index", "edge_type", "y", "train_mask", "test_mask"):
        np.testing.assert_array_equal(data[k], np.asarray(getattr(g, k)))
    targs = rgcn_trainer.parser().parse_args(["--device", "cpu",
                                              "--n_epoch", "5"])
    n = data["num_nodes"]
    model = JaxRGCNModel(targs.feat_dim, targs.hidden_dim, 4, num_rel,
                         num_bases=targs.num_bases)
    x = jnp.eye(n, targs.feat_dim, dtype=jnp.float32)
    ei, et = jnp.asarray(data["edge_index"]), jnp.asarray(data["edge_type"])
    params = model.init(jax.random.PRNGKey(0), x, ei, et)
    want = _jax_steps(lambda p: jax_loss(
        model.apply(p, x, ei, et), jnp.asarray(data["y"]),
        jnp.asarray(data["train_mask"])), params, targs.lr, 5)
    got = rgcn_trainer.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


def test_han_twin_matches_the_jax_trainer(monkeypatch):
    """The JAX trainer's fallback graph (IMDB made to fail) is the twin's
    default, and 5 steps with dropout off give the JAX trainer's losses."""
    monkeypatch.setattr(jax_datasets, "IMDB", _no_dataset)
    jhg, target = jax_han.load(argparse.Namespace(dataset_path="data"))
    hg, target2 = common.synthetic_hetero()
    assert target == target2
    for nt in hg.node_types:
        np.testing.assert_array_equal(hg[nt].x, np.asarray(jhg[nt].x))
    for k in ("y", "train_mask", "test_mask"):
        np.testing.assert_array_equal(hg[target][k],
                                      np.asarray(jhg[target][k]))
    for et, ei in hg.edge_index_dict.items():
        np.testing.assert_array_equal(ei, np.asarray(jhg[et].edge_index))
    targs = han_trainer.parser().parse_args(
        ["--device", "cpu", "--n_epoch", "5", "--drop_rate", "0"])
    jhg = jhg.tensor()
    model = JaxHANModel(jhg.metadata(), targs.hidden_dim, 3, target,
                        heads=targs.heads, drop_rate=0.0)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key}, jhg.x_dict,
                        jhg.edge_index_dict)
    y, mask = jnp.asarray(hg[target].y), jnp.asarray(hg[target].train_mask)
    want = _jax_steps(lambda p: jax_loss(model.apply(
        p, jhg.x_dict, jhg.edge_index_dict, train=True), y, mask), params,
        targs.lr, 5)
    got = han_trainer.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


def test_simplehgn_twin_matches_the_jax_trainer():
    """The twin's flattened graph is the JAX trainer's, and 5 steps of its
    loop give the JAX trainer's losses."""
    x, ei, et, y, n_m, n_rel, train_mask, _ = jax_simplehgn.typed_graph(None)
    data = simplehgn_trainer.typed_graph()
    for got, want in ((data["x"], x), (data["edge_index"], ei),
                      (data["edge_type"], et), (data["y"], y),
                      (data["train_mask"], train_mask)):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert data["num_relations"] == n_rel and len(data["y"]) == n_m
    targs = simplehgn_trainer.parser().parse_args(["--device", "cpu",
                                                   "--n_epoch", "5"])
    model = JaxSimpleHGNModel(n_rel, targs.hidden_dim, 3, heads=2,
                              drop_rate=0.0)
    key = jax.random.PRNGKey(0)
    params = model.init({"params": key, "dropout": key}, x, ei, et)
    want = _jax_steps(lambda p: jax_loss(model.apply(p, x, ei, et)[:n_m], y,
                                         train_mask), params, targs.lr, 5)
    got = simplehgn_trainer.main(targs, params=_np_tree(params))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twins_train_on_the_cpu(name, capsys):
    module = TWINS[name]
    args = module.parser().parse_args(["--device", "cpu", "--n_epoch",
                                       "12"])
    out = module.main(args)
    losses = out["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] and 0.0 <= out["test_acc"] <= 1
    assert "final test acc" in capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twins_default_to_the_card(name, monkeypatch):
    """``--device`` defaults to cuda; without a card the twin raises
    before it builds anything, rather than falling back to the CPU."""
    module = TWINS[name]
    assert module.parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(module.parser().parse_args(["--n_epoch", "1"]))
