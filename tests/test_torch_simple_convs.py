"""The port's propagation zoo's convs (`layers/conv/simple_convs.py`)
against the JAX package; its models are held in
`test_torch_simple_models.py` and its trainer twins in
`test_torch_simple_twins.py`, with the helpers of this file.

Each case builds the JAX module's parameters with its own ``init``,
carries them across with `load_jax_params`, and runs the same numpy
inputs (from a seed) through both packages: on the COO route (no plan)
against the JAX XLA path, and on the plan route (the port's `CSRPlan`,
whose kernels run their plain versions here) against the JAX layers with
`build_csr_plan` (Pallas in interpret mode). The graphs leave their last
rows without edges.

Tolerances, float32, relative to max |out| (each parameter's and the
input's max |grad| for gradients): 1e-5 against the XLA path, 1e-4
against the Pallas path (its f32 products drop the lo*lo term of
bf16x3), gradients 1e-4 (the gradients of sum(out * g) for a fixed g).
"""

import os.path as osp
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import gammagl_tpu.layers.conv as jconv  # noqa: E402
from gammagl_tpu.ops.pallas import (  # noqa: E402
    build_csr_plan as jax_build_csr_plan)

import gammagl_tpu_torch.layers.conv as tconv  # noqa: E402
from gammagl_tpu_torch.ops.cuda import build_csr_plan  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402
from gammagl_tpu_torch.utils.params import _layout  # noqa: E402

ROUTES = ["coo", "plan"]


def _check(got, want, tol):
    """|got - want| <= tol * max |want|, elementwise."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _np_tree(params):
    """flax variables as numpy, with a "params" entry even for a module
    that has none."""
    return {"params": jax.tree_util.tree_map(np.asarray,
                                             params.get("params", {}))}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _check_grads(module, jax_grads, tol, zero=()):
    """The port's parameter gradients, under their flax names (kernels
    transposed back; a parameter the loss does not reach gives zeros, as
    in JAX), against jax.grad's, each at tol of its own max |grad|. The
    gradients named in ``zero`` are 0 by the math (both sides hold
    rounding noise) and are held at tol of the module's largest."""
    want = dict(_flat(jax_grads.get("params", {})))
    got = {}
    for path, (p, transpose) in _layout(module).items():
        g = (np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.detach().numpy())
        got["/".join(path)] = g.T if transpose else g
    assert sorted(got) == sorted(want)
    largest = max((float(np.abs(v).max()) for v in want.values()),
                  default=0.0)
    for name in want:
        if name in zero:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=tol * largest)
        else:
            _check(got[name], want[name], tol)


def _jax_out_and_grads(f, loss_of_out, *args, argnums=0):
    """``f(*args)`` and the gradients of ``loss_of_out`` of it in the
    arguments ``argnums``, under one jit (one compile for both)."""
    def loss(*a):
        out = f(*a)
        return loss_of_out(out), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(*args)
    return out, grads


def _graph(seed=0, n=40, e=160, isolated=10):
    """n nodes, e random edges; the last ``isolated`` rows receive none."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n, e),
                     rng.integers(0, n - isolated, e)]), n


def _plans(ei, n, route):
    if route == "coo":
        return None, None
    return (jax_build_csr_plan(ei[0], ei[1], n, R=8, ET=32),
            build_csr_plan(ei[0], ei[1], n))


# name -> (JAX conv, port conv, extra keyword arguments of both calls);
# every conv is called as conv(x, edge_index, ...), GCNII as conv(x, x0,
# edge_index, ...)
CONVS = {
    "sgc": (lambda: jconv.SGConv(6, itera_k=2),
            lambda: tconv.SGConv(8, 6, itera_k=2), {}),
    "sgc_weighted": (lambda: jconv.SGConv(6, itera_k=2),
                     lambda: tconv.SGConv(8, 6, itera_k=2),
                     {"edge_weight": True}),
    "gin": (lambda: jconv.GINConv(init_eps=0.1, learn_eps=True),
            lambda: tconv.GINConv(init_eps=0.1, learn_eps=True), {}),
    "appnp": (lambda: jconv.APPNPConv(itera_k=3, alpha=0.2),
              lambda: tconv.APPNPConv(itera_k=3, alpha=0.2), {}),
    "gcnii": (lambda: jconv.GCNIIConv(8, beta=0.3, alpha=0.2),
              lambda: tconv.GCNIIConv(8, 8, beta=0.3, alpha=0.2), {}),
    "gcnii_variant": (
        lambda: jconv.GCNIIConv(8, beta=0.3, alpha=0.2, variant=True),
        lambda: tconv.GCNIIConv(8, 8, beta=0.3, alpha=0.2, variant=True),
        {}),
    "cheb": (lambda: jconv.ChebConv(6, K=3),
             lambda: tconv.ChebConv(8, 6, K=3), {}),
    "cheb_lambda": (lambda: jconv.ChebConv(6, K=4),
                    lambda: tconv.ChebConv(8, 6, K=4), {"lambda_max": 1.5}),
    "agnn": (lambda: jconv.AGNNConv(init_beta=1.5),
             lambda: tconv.AGNNConv(init_beta=1.5), {}),
    "fagcn": (lambda: jconv.FAGCNConv(8), lambda: tconv.FAGCNConv(8), {}),
    "gpr": (lambda: jconv.GPRConv(K=3, alpha=0.2),
            lambda: tconv.GPRConv(K=3, alpha=0.2), {}),
    "gpr_uniform": (lambda: jconv.GPRConv(K=3, weight_init="uniform"),
                    lambda: tconv.GPRConv(K=3, weight_init="uniform"), {}),
    "mixhop": (lambda: jconv.MixHopConv(4, p=(0, 1, 3)),
               lambda: tconv.MixHopConv(8, 4, p=(0, 1, 3)), {}),
}


def _conv_case(name, ei, n, seed=1):
    """(JAX conv, its flax variables, apply(params, x, plan), port conv
    loaded from them, call(x, plan), x) on the graph ``ei``."""
    make_jax, make_port, kw = CONVS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    x0 = rng.normal(size=(n, 8)).astype(np.float32)
    kw = dict(kw)
    jkw, tkw = {}, {}
    if kw.pop("edge_weight", False):
        w = rng.random(ei.shape[1]).astype(np.float32) + 0.5
        jkw["edge_weight"] = jnp.asarray(w)
        tkw["edge_weight"] = torch.tensor(w)
    jkw.update(kw)
    tkw.update(kw)
    lead = (x0,) if name.startswith("gcnii") else ()
    jm, jei = make_jax(), jnp.asarray(ei)
    jlead = tuple(jnp.asarray(a) for a in lead)
    params = _np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                              *jlead, jei, **jkw))

    def apply(p, jx, jplan):
        return jm.apply(p, jx, *jlead, jei, plan=jplan, **jkw)

    conv = load_jax_params(make_port(), params)
    tei, tlead = torch.tensor(ei), tuple(torch.tensor(a) for a in lead)

    def call(tx, plan):
        return conv(tx, *tlead, tei, plan=plan, **tkw)

    return jm, params, apply, conv, call, x


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_matches_jax(name, route):
    """Forward, and the gradients of sum(out * g) in the parameters and in
    x (the backward of each hop: on the plan route the SpMM on the
    transpose plan, and for AGNN's and FAGCN's weights the SDDMM)."""
    ei, n = _graph()
    jplan, plan = _plans(ei, n, route)
    _, params, apply, conv, call, x = _conv_case(name, ei, n)
    fwd = lambda p, jx: apply(p, jx, jplan)  # noqa: E731
    shape = jax.eval_shape(fwd, params, jnp.asarray(x)).shape
    g = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want, (jgrads, jdx) = _jax_out_and_grads(
        fwd, lambda out: (out * jnp.asarray(g)).sum(), params,
        jnp.asarray(x), argnums=(0, 1))
    tx = torch.tensor(x, requires_grad=True)
    got = call(tx, plan)
    _check(got, want, 1e-5 if route == "coo" else 1e-4)
    (got * torch.tensor(g)).sum().backward()
    _check_grads(conv, jgrads, 1e-4)
    _check(tx.grad, jdx, 1e-4)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_without_edges_matches_jax(name):
    """E == 0: both routes give the JAX function (a plan of no edges)."""
    ei = np.zeros((2, 0), np.int64)
    n = 12
    _, params, apply, _, call, x = _conv_case(name, ei, n)
    want = apply(params, jnp.asarray(x), None)
    for route in ROUTES:
        plan = None if route == "coo" else build_csr_plan(ei[0], ei[1], n)
        with torch.no_grad():
            _check(call(torch.tensor(x), plan), want, 1e-5)


def test_isolated_rows_give_zero_after_propagation():
    """SGConv's rows that receive no edge are exactly 0 on both routes,
    as in JAX (the map's bias is propagated, not added after)."""
    ei, n = _graph()
    _, params, apply, _, call, x = _conv_case("sgc", ei, n)
    want = np.asarray(apply(params, jnp.asarray(x), None))
    assert (want[-10:] == 0).all()
    for route in ROUTES:
        with torch.no_grad():
            got = call(torch.tensor(x), _plans(ei, n, route)[1])
        assert (got[-10:] == 0).all() and got[:-10].abs().sum() > 0


@pytest.mark.parametrize("mode", ["cat", "max", "att"])
def test_jumping_knowledge_matches_jax(mode):
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(20, 6)).astype(np.float32) for _ in range(3)]
    jm = jconv.JumpingKnowledge(mode=mode)
    jxs = [jnp.asarray(a) for a in xs]
    params = _np_tree(jm.init(jax.random.PRNGKey(4), jxs))
    want = jm.apply(params, jxs)
    g = rng.normal(size=want.shape).astype(np.float32)
    jgrads, jdxs = jax.grad(
        lambda p, xs: (jm.apply(p, xs) * jnp.asarray(g)).sum(),
        argnums=(0, 1))(params, jxs)
    jk = load_jax_params(tconv.JumpingKnowledge(mode=mode), params)
    txs = [torch.tensor(a, requires_grad=True) for a in xs]
    got = jk(txs)
    _check(got, want, 1e-5)
    (got * torch.tensor(g)).sum().backward()
    # a softmax over the layers ignores the score's bias
    _check_grads(jk, jgrads, 1e-4, zero=("Dense_0/bias",))
    for tx, jdx in zip(txs, jdxs):
        _check(tx.grad, jdx, 1e-4)
    with pytest.raises(ValueError, match="unknown mode"):
        tconv.JumpingKnowledge(mode="lstm")


def _c19_hub():
    """600 sources, each with a self-loop, all pointing into node 0, which
    has a self-loop too: a row of 601 in-edges."""
    n = 601
    src = np.concatenate([np.arange(1, n), np.arange(n)])
    dst = np.concatenate([np.zeros(n - 1, np.int64), np.arange(n)])
    return np.stack([src, dst]), n


@pytest.mark.parametrize("name,jax_value,port_value", [
    ("appnp", 16.0, 24.5), ("gpr", 8.5, 12.75)])
def test_c19_bf16_degrees_do_not_saturate_unlike_the_reference(
        name, jax_value, port_value):
    """ROADMAP C19, C1 in the zoo: at a row of 601 in-edges, bfloat16
    ones, one hop (APPNP at alpha 0; GPR-GNN at K = 1, uniform, half the
    input plus half the hop), the JAX layers count the row's degree in
    bfloat16 (256) and sum its messages in bfloat16 (stuck at 16 once the
    sum reaches 16); the port counts in float32 and sums in float32:
    601 / sqrt(601) = 24.5. In float32 the two packages agree."""
    ei, n = _c19_hub()
    make = {"appnp": (lambda: jconv.APPNPConv(itera_k=1, alpha=0.0),
                      lambda: tconv.APPNPConv(itera_k=1, alpha=0.0)),
            "gpr": (lambda: jconv.GPRConv(K=1, weight_init="uniform"),
                    lambda: tconv.GPRConv(K=1, weight_init="uniform"))}[name]
    jm = make[0]()
    ones = np.ones((n, 1), np.float32)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(ones),
                              jnp.asarray(ei)))
    conv = load_jax_params(make[1](), params)
    want = jm.apply(params, jnp.asarray(ones, jnp.bfloat16), jnp.asarray(ei))
    with torch.no_grad():
        got = conv(torch.tensor(ones, dtype=torch.bfloat16),
                   torch.tensor(ei))
        f32 = conv(torch.tensor(ones), torch.tensor(ei))
    assert float(want[0, 0]) == jax_value
    assert float(got[0, 0]) == port_value
    _check(f32, jm.apply(params, jnp.asarray(ones), jnp.asarray(ei)), 1e-5)


def test_c20_agnn_input_gradient_at_a_zero_row():
    """ROADMAP C20: both packages normalise rows as x / (|x| + 1e-12). At
    an all-zero row JAX's gradient of the norm is NaN, while torch's
    `vector_norm` backward gives 0 there, so the port's input gradient at
    that row is the cotangent over 1e-12: finite and huge. The outputs,
    beta's gradient and the other rows' input gradients agree."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 4)).astype(np.float32)
    x[2] = 0.0
    ring = np.arange(6)
    ei = np.concatenate([np.stack([ring, (ring + 1) % 6]),
                         np.stack([ring, ring])], axis=1)
    jm = jconv.AGNNConv(init_beta=1.0)
    params = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              jnp.asarray(ei)))
    g = rng.normal(size=(6, 4)).astype(np.float32)
    want, (jgrads, jdx) = _jax_out_and_grads(
        lambda p, jx: jm.apply(p, jx, jnp.asarray(ei)),
        lambda out: (out * jnp.asarray(g)).sum(), params, jnp.asarray(x),
        argnums=(0, 1))
    conv = load_jax_params(tconv.AGNNConv(init_beta=1.0), params)
    tx = torch.tensor(x, requires_grad=True)
    got = conv(tx, torch.tensor(ei))
    _check(got, want, 1e-5)
    (got * torch.tensor(g)).sum().backward()
    _check_grads(conv, jgrads, 1e-5)
    jdx = np.asarray(jdx)
    dx = tx.grad.numpy()
    assert np.isnan(jdx[2]).all() and np.isfinite(dx[2]).all()
    assert np.abs(dx[2]).max() > 1e6
    others = np.arange(6) != 2
    _check(dx[others], jdx[others], 1e-5)
