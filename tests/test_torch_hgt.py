"""The port's HeteroGraph, HGTConv, HGTModel and hgt trainer twin against
the JAX package.

HGTConv takes one of three routes, by the JAX layer's own conditions: the
fused kernel (a window plan, bf16, H*D % 128 == 0, no dropout in force),
the decomposed plan route (gather, expand, flash softmax-sum), or the COO
route (no plan). Each test hands both packages the same parameters (a JAX
init carried across with `load_jax_params`) and the same plans' edges, and
checks that the port takes the route the JAX layer takes.

Tolerances, relative to max |out| (max |grad| for gradients), at init:
f32 1e-5 on the COO route and 1e-4 with a plan (bf16x3 products in the
JAX kernels); bf16 3e-2 (the packages round at different points; the JAX
fused kernels round p and ds to bf16). Train-mode losses cannot be
matched across the packages (the masks come from different generators),
so the twin is held against the JAX trainer's loss with ``train=False``,
and the port's own train-mode routes against each other. Each JAX
reference but the bf16 twin's is one jitted call (its forward, or its
loss and gradients, under one compile), which also runs the Pallas
kernels' interpret mode compiled rather than step by step. The JAX
layers and models, their jitted ``init`` and their jitted forwards are
built once for the module (cached by configuration), so cases of one
configuration share one compile.
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
import gammagl_tpu.ops.pallas as jax_pallas  # noqa: E402
from examples.common import (  # noqa: E402
    synthetic_hetero as jax_synthetic_hetero)
from gammagl_tpu.layers.conv import HGTConv as JaxHGTConv  # noqa: E402
from gammagl_tpu.models import HGTModel as JaxHGTModel  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402

from gammagl_tpu_torch.data import HeteroGraph  # noqa: E402
from gammagl_tpu_torch.examples import common, hgt_trainer  # noqa: E402
from gammagl_tpu_torch.layers.conv import (  # noqa: E402
    HGTConv, HeteroConv, SAGEConv)
from gammagl_tpu_torch.layers.conv import hetero_conv  # noqa: E402
from gammagl_tpu_torch.models import HGTModel  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
ROUTES = {  # route -> (plan window, or None for no plan)
    "coo": None, "decomposed": False, "fused": True}


def _graphs(seed=0):
    """The JAX trainers' synthetic typed graph, from both packages."""
    jhg, target = jax_synthetic_hetero(seed)
    hg, target2 = common.synthetic_hetero(seed)
    assert target == target2 == "movie"
    return jhg, hg, target


def _inputs(hg):
    x_dict = {nt: np.asarray(x, np.float32) for nt, x in hg.x_dict.items()}
    return x_dict, dict(hg.edge_index_dict)


def _perturb(params, seed):
    """Priors and skip gates away from their init of 1, so they matter."""
    rng = np.random.default_rng(seed)

    def visit(tree):
        return {k: visit(v) if isinstance(v, dict) else (
            np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v)).astype(
                np.float32) if k.startswith(("pri__", "skip__"))
            else np.asarray(v)) for k, v in tree.items()}
    return {"params": visit(params["params"])}


def _check(got, want, tol, floor=0.0):
    """|got - want| <= tol * max(max |want|, floor), elementwise."""
    got = got.float().detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), floor))


def _grad_floor(grads):
    """The scale below which a parameter's gradient is held at this scale
    rather than its own: 0.05 of the model's largest gradient. Below it a
    gradient is a sum that cancels (the first layer's skip gate of the
    type the loss does not read: 0.004 of the largest, 0.16 apart in
    bf16), or zero by the math and rounding noise: the k projections'
    biases (a softmax ignores a per-row constant) and the keys of a
    relation where every destination has one edge (a softmax over one
    edge)."""
    return 0.05 * max(float(np.abs(np.asarray(g, np.float32)).max())
                      for g in grads)


def _tol(dtype, route):
    if dtype == "bf16":
        return 3e-2
    return 1e-5 if route == "coo" else 1e-4


@pytest.fixture
def fused_calls(monkeypatch):
    """Count the fused-kernel calls of each package's HGTConv."""
    calls = {"jax": 0, "port": 0}
    jax_fn, port_fn = jax_pallas.hgt_flash_packed, hetero_conv.hgt_flash_packed

    def jax_counted(*a, **kw):
        calls["jax"] += 1
        return jax_fn(*a, **kw)

    def port_counted(*a, **kw):
        calls["port"] += 1
        return port_fn(*a, **kw)

    monkeypatch.setattr(jax_pallas, "hgt_flash_packed", jax_counted)
    monkeypatch.setattr(hetero_conv, "hgt_flash_packed", port_counted)
    return calls


def test_heterograph_matches_jax_and_caches_plans():
    jhg, hg, _ = _graphs(1)
    assert hg.metadata() == jhg.metadata()
    assert (hg.node_types, hg.edge_types) == (jhg.node_types, jhg.edge_types)
    assert (hg.num_nodes, hg.num_edges) == (jhg.num_nodes, jhg.num_edges)
    for nt in hg.node_types:
        np.testing.assert_array_equal(hg.x_dict[nt], jhg.x_dict[nt])
        assert hg[nt].num_nodes == jhg[nt].num_nodes
    for et in hg.edge_types:
        np.testing.assert_array_equal(hg.edge_index_dict[et],
                                      jhg.edge_index_dict[et])
    assert ("director", "movie") not in hg and ("movie", "mdm", "movie") in hg
    plans = hg.csr_plans()
    assert plans is hg.csr_plans() and set(plans) == set(hg.edge_types)
    assert all(p.window for p in plans.values())
    padded = hg.csr_plans(window=False)
    assert padded is not plans and not any(p.window for p in padded.values())
    # R and ET change no layout: one cache per window
    assert hg.csr_plans(R=8, ET=16) is plans
    et = ("director", "directs", "movie")
    p = plans[et]
    assert (p.num_nodes, p.num_src, p.num_edges) == (200, 60, 200)
    ei = hg.edge_index_dict[et]
    np.testing.assert_array_equal(p.col, ei[0][p.perm])
    # graph-level values and 2-tuple edge keys, as in the JAX container
    g = HeteroGraph()
    g["split"] = "train"
    g[("a", "b")].edge_index = np.zeros((2, 3), np.int64)
    assert g["split"] == "train" and g.edge_types == [("a", "to", "b")]
    assert g.csr_plans() == {}  # endpoint types without sizes: no plan


@functools.lru_cache(maxsize=None)
def _jax_graph():
    """The JAX package's synthetic typed graph (seed 0), its inputs as
    arrays, and its plans by window (built once)."""
    jhg, hg, _ = _graphs()
    x_dict, ei_dict = _inputs(hg)
    jx = {k: jnp.asarray(v) for k, v in x_dict.items()}
    jei = {k: jnp.asarray(v) for k, v in ei_dict.items()}
    plans = {None: None}
    for window in (False, True):
        plans[window] = jhg.csr_plans(R=8, ET=32, window=window)
    return jhg, jx, jei, plans


@functools.lru_cache(maxsize=None)
def _jax_conv(dtype, heads, out):
    """(JAX HGTConv, its jitted init) of one configuration."""
    _, hg, _ = _graphs()
    jconv = JaxHGTConv(out_channels=out, metadata=hg.metadata(), heads=heads,
                       dtype=DTYPES[dtype][0])
    return jconv, jax.jit(jconv.init)


@functools.lru_cache(maxsize=None)
def _jax_forward(kind, dtype, heads, width, window):
    """The jitted forward of the cached JAX conv or model of one
    configuration on the cached graph's plans of ``window``."""
    module = (_jax_conv(dtype, heads, width)[0] if kind == "conv"
              else _jax_model(dtype, width, heads)[0])
    _, jx, jei, plans = _jax_graph()
    jplans = plans[window]
    return jax.jit(lambda p: module.apply(p, jx, jei, plan_dict=jplans))


def _conv_case(route, dtype, heads=2, out=128, seed=2):
    jhg, hg, _ = _graphs()
    x_dict, ei_dict = _inputs(hg)
    tdt = DTYPES[dtype][1]
    window = ROUTES[route]
    jplans = _jax_graph()[3][window]
    tplans = None if window is None else hg.csr_plans(window=window)
    jconv, init = _jax_conv(dtype, heads, out)
    _, jx, jei, _ = _jax_graph()
    params = init(jax.random.PRNGKey(seed), jx, jei)
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), seed)
    conv = load_jax_params(HGTConv(None, out, hg.metadata(), heads=heads,
                                   dtype=tdt), params).eval()
    tx = {k: torch.tensor(v) for k, v in x_dict.items()}
    tei = {k: torch.tensor(v) for k, v in ei_dict.items()}
    return jconv, params, jx, jei, jplans, conv, tx, tei, tplans


@pytest.mark.parametrize("route,dtype", [
    ("coo", "f32"), ("coo", "bf16"), ("decomposed", "f32"),
    ("decomposed", "bf16"), ("fused", "f32"), ("fused", "bf16")])
def test_hgt_conv_matches_jax_on_each_route(route, dtype, fused_calls):
    """A window plan fuses in bf16 only (H*D = 128, D = 64); in f32 both
    packages take the decomposed route on it."""
    (jconv, params, jx, jei, jplans, conv, tx, tei,
     tplans) = _conv_case(route, dtype)
    want = _jax_forward("conv", dtype, 2, 128, ROUTES[route])(params)
    got = conv(tx, tei, plan_dict=tplans)
    assert sorted(got) == sorted(want) == ["director", "movie"]
    fused = route == "fused" and dtype == "bf16"
    assert fused_calls == {"jax": 3 * fused, "port": 3 * fused}
    for nt in want:
        assert got[nt].dtype == torch.float32
        _check(got[nt], want[nt], _tol(dtype, route))


def test_hgt_conv_needs_the_widths_to_fuse(fused_calls):
    """H*D = 96 is no multiple of 128: a bf16 window plan takes the
    decomposed route in both packages."""
    (jconv, params, jx, jei, jplans, conv, tx, tei,
     tplans) = _conv_case("fused", "bf16", heads=3, out=96)
    want = _jax_forward("conv", "bf16", 3, 96, True)(params)
    got = conv(tx, tei, plan_dict=tplans)
    assert fused_calls == {"jax": 0, "port": 0}
    for nt in want:
        _check(got[nt], want[nt], 3e-2)


@functools.lru_cache(maxsize=None)
def _jax_model(dtype, hidden, heads):
    """(JAX HGTModel, its jitted init) of one configuration."""
    _, hg, target = _graphs()
    jmodel = JaxHGTModel(metadata=hg.metadata(), hidden_channels=hidden,
                         num_class=3, target_ntype=target, heads=heads,
                         dtype=DTYPES[dtype][0])
    return jmodel, jax.jit(jmodel.init)


def _model_case(dtype, hidden, heads, seed=3):
    jhg, hg, target = _graphs()
    x_dict, ei_dict = _inputs(hg)
    tdt = DTYPES[dtype][1]
    jmodel, init = _jax_model(dtype, hidden, heads)
    jhg, jx, jei, _ = _jax_graph()
    key = jax.random.PRNGKey(seed)
    params = init({"params": key, "dropout": key}, jx, jei)
    params = _perturb(jax.tree_util.tree_map(np.asarray, params), seed)
    model = load_jax_params(HGTModel(hg.metadata(), hidden, 3, target,
                                     heads=heads, dtype=tdt), params)
    tx = {k: torch.tensor(v) for k, v in x_dict.items()}
    tei = {k: torch.tensor(v) for k, v in ei_dict.items()}
    return jhg, hg, jmodel, params, jx, jei, model, tx, tei


@pytest.mark.parametrize("route,dtype", [("coo", "f32"),
                                         ("decomposed", "f32"),
                                         ("fused", "bf16")])
def test_hgt_model_logits_match_jax(route, dtype, fused_calls):
    jhg, hg, jmodel, params, jx, jei, model, tx, tei = _model_case(
        dtype, 128, 2)
    window = ROUTES[route]
    tplans = None if window is None else hg.csr_plans(window=window)
    want = _jax_forward("model", dtype, 2, 128, window)(params)
    got = model.eval()(tx, tei, plan_dict=tplans)
    assert got.shape == (200, 3)
    fused = route == "fused"
    assert fused_calls == {"jax": 6 * fused, "port": 6 * fused}
    _check(got, want, _tol(dtype, route))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _port_grads(model):
    """{flax path: gradient}, kernels transposed back to flax's layout; a
    parameter the loss does not reach (the last layer's maps of the other
    node type) has none, where jax.grad gives zeros."""
    out = {}

    def grad(p):
        return torch.zeros_like(p) if p.grad is None else p.grad

    def visit(module, prefix):
        for name, child in module.flax_tree().items():
            if isinstance(child, torch.nn.Linear):
                out[f"{prefix}{name}/kernel"] = grad(child.weight).T
                out[f"{prefix}{name}/bias"] = grad(child.bias)
            elif isinstance(child, torch.nn.Module):
                visit(child, f"{prefix}{name}/")
            else:
                out[f"{prefix}{name}"] = grad(child)
    visit(model, "")
    return out


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 3e-2)])
def test_twin_loss_and_gradients_match_the_jax_trainer(dtype, tol,
                                                       fused_calls):
    """The twin's loss and backward (`common.loss_and_grad`) with
    ``train=False`` against jax.value_and_grad of the JAX trainer's loss
    with ``train=False``, on window plans at H*D = 128: in bf16 both run
    `hgt_flash_packed`'s VJP, in f32 the decomposed route."""
    jhg, hg, jmodel, params, jx, jei, model, tx, tei = _model_case(
        dtype, 128, 2, seed=4)
    y, mask = hg["movie"].y, hg["movie"].train_mask
    jplans = _jax_graph()[3][True]

    def loss_fn(p):
        logits = jmodel.apply(p, jx, jei, train=False, plan_dict=jplans)
        return jax_loss(logits, jnp.asarray(y), jnp.asarray(mask))

    value_and_grad = jax.value_and_grad(loss_fn)
    if dtype == "f32":
        # bf16 stays eager: under jit XLA fuses the bf16 ops and moves
        # their rounding points; the bf16 bound was set on the eager
        # reference
        value_and_grad = jax.jit(value_and_grad)
    want_loss, want = value_and_grad(params)
    want = dict(_flat(want["params"]))
    loss = common.loss_and_grad(model.eval(), tx, tei, torch.tensor(y),
                                torch.tensor(mask),
                                plan_dict=hg.csr_plans())
    fused = dtype == "bf16"
    assert fused_calls == {"jax": 6 * fused, "port": 6 * fused}
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=1e-5 if dtype == "f32" else 1e-2)
    got = _port_grads(model)
    assert sorted(got) == sorted(want)
    floor = _grad_floor(want.values())
    for name in want:
        _check(got[name], want[name], tol, floor)


def test_train_mode_decomposed_route_matches_the_coo_route(fused_calls):
    """Dropout 0.2 in training mode: both routes draw each relation's mask
    in CSR order from one generator state (the COO route scatters it into
    edge order), so their outputs and gradients agree."""
    _, hg, _ = _graphs()
    x_dict, ei_dict = _inputs(hg)
    tx = {k: torch.tensor(v) for k, v in x_dict.items()}
    tei = {k: torch.tensor(v) for k, v in ei_dict.items()}
    y = torch.tensor(hg["movie"].y)
    results = []
    for plans in (hg.csr_plans(), None):
        torch.manual_seed(5)
        model = HGTModel(hg.metadata(), 32, 3, "movie", heads=2,
                         in_channels=32).train()
        gen = torch.Generator().manual_seed(6)
        logits = model(tx, tei, plan_dict=plans, generator=gen)
        torch.nn.functional.cross_entropy(logits, y).backward()
        results.append((logits, [p.grad for p in model.parameters()]))
    (lp, gp), (lc, gc) = results
    assert fused_calls["port"] == 0
    _check(lp, lc.detach(), 1e-5)
    floor = _grad_floor([g for g in gc if g is not None])
    for a, b in zip(gp, gc):
        if b is None:  # unreached by the loss on both routes
            assert a is None
        else:
            _check(a, b, 1e-5, floor)
    conv = model.convs[0]
    keep = hetero_conv._csr_order_keep(
        conv, torch.Generator().manual_seed(1),
        tei[("movie", "mdm", "movie")], None, "cpu")
    assert 0.1 < float((keep == 0).float().mean()) < 0.3  # rate 0.2


def test_hetero_conv_matches_jax():
    """HeteroConv with one SAGEConv a relation, summed per destination."""
    from gammagl_tpu.layers.conv import SAGEConv as JaxSAGEConv
    from gammagl_tpu.layers.conv.hetero_conv import HeteroConv as JaxHetero
    _, hg, _ = _graphs()
    x_dict, ei_dict = _inputs(hg)
    ets = hg.edge_types
    jconv = JaxHetero({et: JaxSAGEConv(8) for et in ets})
    jx = {k: jnp.asarray(v) for k, v in x_dict.items()}
    jei = {k: jnp.asarray(v) for k, v in ei_dict.items()}
    params = jax.tree_util.tree_map(
        np.asarray, jconv.init(jax.random.PRNGKey(7), jx, jei))
    want = jconv.apply(params, jx, jei)
    conv = load_jax_params(HeteroConv({et: SAGEConv(None, 8) for et in ets}),
                           params)
    got = conv({k: torch.tensor(v) for k, v in x_dict.items()},
               {k: torch.tensor(v) for k, v in ei_dict.items()})
    assert sorted(got) == sorted(want)
    for nt in want:
        _check(got[nt], want[nt], 1e-5)
    stacked = [torch.ones(2, 3), 2 * torch.ones(2, 3)]
    assert float(hetero_conv._group(stacked, "mean")[0, 0]) == 1.5
    assert hetero_conv._group(stacked, "cat").shape == (2, 6)
    with pytest.raises(ValueError, match="unknown aggr"):
        hetero_conv._group(stacked, "prod")


def test_hgt_twin_trains_on_the_cpu(capsys):
    args = hgt_trainer.parser().parse_args(["--device", "cpu", "--n_epoch",
                                            "12"])
    assert (args.hidden_dim, args.lr, args.device) == (16, 0.005, "cpu")
    out = hgt_trainer.main(args)
    losses = out["losses"]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] and 0.0 <= out["test_acc"] <= 1
    assert "final test acc" in capsys.readouterr().out
