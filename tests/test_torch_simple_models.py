"""The port's propagation zoo's models (`models/simple_models.py`)
against the JAX package, with the helpers and tolerances of
`test_torch_simple_convs.py`: each model filled from the JAX model's own
``init`` tree, logits at 1e-5 of max |out| against XLA (COO route) and
1e-4 against the Pallas path (plan route), gradients of the masked
cross-entropy at 1e-4 of each parameter's max |grad|.
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.models as jmodels  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402

import gammagl_tpu_torch.layers.conv as tconv  # noqa: E402
import gammagl_tpu_torch.models as tmodels  # noqa: E402
from gammagl_tpu_torch.ops.cuda import build_csr_plan  # noqa: E402
from gammagl_tpu_torch.train import semi_supervised_loss  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402
from tests.test_torch_simple_convs import (  # noqa: E402
    ROUTES, _check, _check_grads, _graph, _jax_out_and_grads, _np_tree,
    _plans)


# name -> (JAX model, port model); forwards take (x, edge_index, plan=)
MODELS = {
    "sgc": (lambda: jmodels.SGCModel(num_class=3, itera_k=2),
            lambda: tmodels.SGCModel(num_class=3, itera_k=2)),
    "appnp": (lambda: jmodels.APPNPModel(8, 3, itera_k=3),
              lambda: tmodels.APPNPModel(8, 3, itera_k=3)),
    "gcnii": (lambda: jmodels.GCNIIModel(8, 3, num_layers=4),
              lambda: tmodels.GCNIIModel(8, 3, num_layers=4)),
    "gcnii_variant": (
        lambda: jmodels.GCNIIModel(8, 3, num_layers=4, variant=True),
        lambda: tmodels.GCNIIModel(8, 3, num_layers=4, variant=True)),
    "jknet_max": (lambda: jmodels.JKNet(8, 3, num_layers=3),
                  lambda: tmodels.JKNet(8, 3, num_layers=3)),
    "jknet_cat": (lambda: jmodels.JKNet(8, 3, num_layers=3, mode="cat"),
                  lambda: tmodels.JKNet(8, 3, num_layers=3, mode="cat")),
    "jknet_att": (lambda: jmodels.JKNet(8, 3, num_layers=3, mode="att"),
                  lambda: tmodels.JKNet(8, 3, num_layers=3, mode="att")),
    "chebnet": (lambda: jmodels.ChebNetModel(8, 3, K=3),
                lambda: tmodels.ChebNetModel(8, 3, K=3)),
    "mixhop": (lambda: jmodels.MixHopModel(9, 3),
               lambda: tmodels.MixHopModel(9, 3)),
    "gprgnn": (lambda: jmodels.GPRGNNModel(8, 3, K=3),
               lambda: tmodels.GPRGNNModel(8, 3, K=3)),
    "fagcn": (lambda: jmodels.FAGCNModel(8, 3, num_layers=2),
              lambda: tmodels.FAGCNModel(8, 3, num_layers=2)),
}


def _labels(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 3, n), rng.random(n) < 0.6


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax_with_its_params(name, route):
    """Each model filled from the JAX model's own init tree (no key
    missing or extra): eval-mode logits and the gradients of the masked
    cross-entropy, on both routes."""
    ei, n = _graph(6)
    jplan, plan = _plans(ei, n, route)
    x = np.random.default_rng(7).normal(size=(n, 10)).astype(np.float32)
    y, mask = _labels(n)
    make_jax, make_port = MODELS[name]
    jm = make_jax()
    jx, jei = jnp.asarray(x), jnp.asarray(ei)
    key = jax.random.PRNGKey(8)
    params = _np_tree(jm.init({"params": key, "dropout": key}, jx, jei))

    def apply(p):
        return jm.apply(p, jx, jei, plan=jplan)

    want, jgrads = _jax_out_and_grads(
        apply, lambda out: jax_loss(out, jnp.asarray(y), jnp.asarray(mask)),
        params)
    model = load_jax_params(make_port(), params).eval()
    got = model(torch.tensor(x), torch.tensor(ei), plan=plan)
    _check(got, want, 1e-5 if route == "coo" else 1e-4)
    semi_supervised_loss(got, torch.tensor(y), torch.tensor(mask)).backward()
    _check_grads(model, jgrads, 1e-4,
                 zero=("JumpingKnowledge_0/Dense_0/bias",))


def test_load_jax_params_names_the_missing_and_the_extra():
    """A GIN tree with one layer's norm renamed: KeyError naming both."""
    jm = jmodels.GINModel(8, 3, num_layers=2)
    x, ei = jnp.ones((5, 4)), jnp.zeros((2, 3), jnp.int32)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), x, ei))
    params["params"]["LayerNorm_9"] = params["params"].pop("LayerNorm_1")
    with pytest.raises(KeyError, match="missing.*LayerNorm_1.*extra"
                                       ".*LayerNorm_9"):
        load_jax_params(tmodels.GINModel(8, 3, num_layers=2), params)


@pytest.mark.parametrize("pooled", ["batch", "whole"])
def test_gin_model_matches_jax(pooled):
    """GINModel (COO, as JAX's takes no plan): the MLPs inlined into the
    model's tree, LayerNorm at flax's epsilon; graph logits with a batch
    vector of 3 graphs, or (1, C) over the whole graph; and the
    gradients."""
    ei, n = _graph(9)
    x = np.random.default_rng(10).normal(size=(n, 6)).astype(np.float32)
    batch = np.repeat(np.arange(3), [15, 15, 10]) if pooled == "batch" \
        else None
    jm = jmodels.GINModel(8, 3, num_layers=3)
    jx, jei = jnp.asarray(x), jnp.asarray(ei)
    jb = None if batch is None else jnp.asarray(batch)
    key = jax.random.PRNGKey(11)
    params = _np_tree(jm.init({"params": key, "dropout": key}, jx, jei, jb))

    def apply(p):
        return jm.apply(p, jx, jei, jb)

    want = apply(params)
    g = np.random.default_rng(12).normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: (apply(p) * jnp.asarray(g)).sum())(params)
    model = load_jax_params(tmodels.GINModel(8, 3, num_layers=3),
                            params).eval()
    got = model(torch.tensor(x), torch.tensor(ei),
                None if batch is None else torch.tensor(batch))
    assert got.shape == ((3, 3) if pooled == "batch" else (1, 3))
    _check(got, want, 1e-5)
    (got * torch.tensor(g)).sum().backward()
    _check_grads(model, jgrads, 1e-4)


def test_mlp_matches_jax():
    x = np.random.default_rng(13).normal(size=(20, 10)).astype(np.float32)
    jm = jmodels.MLP((8, 4), num_class=3)
    params = _np_tree(jm.init(jax.random.PRNGKey(14), jnp.asarray(x)))
    model = load_jax_params(tmodels.MLP((8, 4), num_class=3), params).eval()
    _check(model(torch.tensor(x)), jm.apply(params, jnp.asarray(x)), 1e-5)


def test_train_mode_plan_route_matches_the_coo_route():
    """Dropout in training mode from one generator state: APPNP with edge
    dropout and FAGCN with gate dropout give the same logits and
    gradients on both routes."""
    ei, n = _graph(15)
    x = torch.tensor(np.random.default_rng(16).normal(
        size=(n, 10)).astype(np.float32))
    plan = build_csr_plan(ei[0], ei[1], n)
    for make in (lambda: tmodels.APPNPModel(8, 3, itera_k=3),
                 lambda: tmodels.FAGCNModel(8, 3)):
        results = []
        for p in (None, plan):
            torch.manual_seed(17)
            model = make()
            for conv in model.modules():
                if isinstance(conv, tconv.APPNPConv):
                    conv.edge_dropout = 0.3
                if isinstance(conv, tconv.FAGCNConv):
                    conv.drop_rate = 0.3
            out = model.train()(x, torch.tensor(ei), plan=p,
                                generator=torch.Generator().manual_seed(18))
            out.square().sum().backward()
            results.append((out.detach(), [q.grad for q in
                                           model.parameters()]))
        (a, ga), (b, gb) = results
        _check(b, a, 1e-5)
        for u, v in zip(gb, ga):
            _check(u, v.numpy(), 1e-5)

