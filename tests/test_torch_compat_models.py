"""The port's `models/compat.py` against the JAX package's.

Every thin model is built in JAX with its own ``init`` (as
`tests/models/test_compat_models.py` builds it), carried across with
`load_jax_params` and fed the same numpy inputs: outputs and losses at
rtol 1e-5, atol 1e-6, and the gradients of a loss of them in every
parameter at rtol 1e-4, atol 1e-6 plus 1e-5 of the parameter's largest
gradient, each JAX reference compiled once for the module.
`FusedGATModel` is held against the JAX model's Pallas route (interpret
mode: its products are bf16x3, so at 1e-5 of max |out|, as
`tests/test_torch_compat_convs.py` holds the conv) and raises without
its plan. MGNNI_m_att is held away from its zero init (C36). The 23
aliases are bound bitwise: each is the port's class of the JAX alias's
target, and ``DGCNN`` is `SEALModel` (not `DGCNNModel`).
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
import gammagl_tpu.models.compat as jc  # noqa: E402
from gammagl_tpu.layers.conv import FusedGATConv as JaxFusedGATConv  # noqa
from tests.test_torch_a6e_models import (  # noqa: E402
    _close, _cot, _dot, _leaves, _t, _torch_leaves)
from tests.test_torch_graph_llm import _grads_close  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402

import gammagl_tpu_torch.models as tm  # noqa: E402
import gammagl_tpu_torch.models.compat as tc  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
N, E, FEAT, C = 12, 40, 6, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tiny():
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N, E)])
    return rng.normal(size=(N, FEAT)).astype(np.float32), ei.astype(np.int64)


def _cases():
    x, ei = _tiny()
    rng = np.random.default_rng(2)
    pos, neg = rng.integers(0, 10, (6, 4)), rng.integers(0, 10, (6, 4))
    u, v = rng.integers(0, 8, 16), rng.integers(0, 8, 16)
    lab = rng.integers(0, 2, 16).astype(np.float32)
    reward = rng.random(16).astype(np.float32)
    eigvecs = _cot((N, 5), 4)
    eigvals = np.linspace(0.0, 2.0, 5).astype(np.float32)
    errs = np.random.default_rng(5).random((7, 3)).astype(np.float32)
    h = _cot((7, 8), 6)
    z = _cot((2, 16), 7)
    graph = ((x, ei), (_t(x), _t(ei)))

    def dot_of(shape, seed):
        return lambda out: _dot(out, _cot(shape, seed))

    def pair_of(shape):
        return lambda out: _dot(out[0], _cot(shape, 8)) + _dot(
            out[1], _cot(shape, 9))

    def same(out):
        return out

    node_out = dot_of((N, C), 3)
    cases = {}
    for name, kw in (("AGNNModel", {}), ("FILMModel", {}),
                     ("GMMModel", {}), ("DNAModel", {}),
                     ("DFADModel", {}), ("GNN", {}),
                     ("GNN_mlp_in", {"use_mlp_in": True})):
        cls = name.split("_")[0]
        cases[name] = (getattr(jc, cls)(num_class=C, hidden_dim=8, **kw),
                       graph[0], getattr(tc, cls)(num_class=C, hidden_dim=8,
                                                  **kw), graph[1], node_out)
    cases.update({
        # the star expansion's N hyperedges (JAX sizes them from the ids
        # when num_edges is None, which a jit cannot)
        "HCHA": (jc.HCHA(num_class=C, hidden_dim=8), (x, ei, None, N, N),
                 tc.HCHA(num_class=C, hidden_dim=8),
                 (_t(x), _t(ei), None, N, N), node_out),
        "MGNNI_m_att": (jc.MGNNI_m_att(num_class=C, hidden_dim=8, iters=3),
                        graph[0],
                        tc.MGNNI_m_att(num_class=C, hidden_dim=8, iters=3),
                        graph[1], node_out),
        "LogReg": (jc.LogReg(3), (x,), tc.LogReg(3), (_t(x),),
                   dot_of((N, 3), 10)),
        "EdgePromptNodeClassifier": (
            jc.EdgePromptNodeClassifier(3), (h,),
            tc.EdgePromptNodeClassifier(3), (_t(h),), dot_of((7, 3), 11)),
        "ReModel": (jc.ReModel(), (errs,), tc.ReModel(), (_t(errs),),
                    dot_of((7,), 12)),
        "SkipGramModel": (jc.SkipGramModel(10, 8), (pos, neg),
                          tc.SkipGramModel(10, 8), (_t(pos), _t(neg)), same),
        "Generator": (jc.Generator(8, 4), (u, v, reward),
                      tc.Generator(8, 4), (_t(u), _t(v), _t(reward)), same),
        "Discriminator": (jc.Discriminator(8, 4), (u, v, lab),
                          tc.Discriminator(8, 4), (_t(u), _t(v), _t(lab)),
                          same),
        "Encoder": (jc.Encoder(8), graph[0], tc.Encoder(8), graph[1],
                    dot_of((N, 8), 13)),
        "EigenMLP": (jc.EigenMLP(8), (eigvecs, eigvals), tc.EigenMLP(8),
                     (_t(eigvecs), _t(eigvals)), dot_of((N, 8), 14)),
        "SpaSpeNode": (jc.SpaSpeNode(8), (x, ei, eigvecs, eigvals),
                       tc.SpaSpeNode(8),
                       (_t(x), _t(ei), _t(eigvecs), _t(eigvals)),
                       pair_of((N, 8))),
        "DFADGenerator": (jc.DFADGenerator(6, 5), (z,),
                          tc.DFADGenerator(6, 5), (_t(z),),
                          lambda out: _dot(out[0], _cot((2, 6, 5), 15))
                          + _dot(out[1], _cot((2, 6, 6), 16))),
    })
    return cases


CASES = _cases()


def _away_from_zero(name, params):
    """MGNNI_m_iter's F starts at zero, where JAX's gradient of it is NaN
    and the port's 0 (C36): the case moves it to small values first."""
    if name != "MGNNI_m_att":
        return params
    p = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(17)
    for key in ("MGNNI_m_iter_0", "MGNNI_m_iter_1"):
        f = p["params"][key]["F"]
        p["params"][key]["F"] = (0.05 * rng.normal(size=f.shape)).astype(
            np.float32)
    return p


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    jmod, jin, _, _, loss_of = CASES[name]
    jin = tuple(a if a is None or isinstance(a, int) else jnp.asarray(a)
                for a in jin)
    params = _away_from_zero(name, jmod.init(KEY, *jin))
    dyn = [i for i, a in enumerate(jin) if a is not None
           and not isinstance(a, int)]

    def loss(p, *arrays):
        args = list(jin)
        for i, a in zip(dyn, arrays):
            args[i] = a
        out = jmod.apply(p, *args)
        return loss_of(out), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(
        params, *(jin[i] for i in dyn))
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_thin_model_output_and_grads_match_jax(name):
    _, _, tmod, tin, loss_of = CASES[name]
    params, want, grads = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    model.zero_grad(set_to_none=True)
    out = model(*tin)
    loss_of(out).backward()
    got, want = _torch_leaves(out), _leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    _grads_close(model, grads)


def test_discriminator_reward_follows_jax():
    jmod, jin, tmod, tin, _ = CASES["Discriminator"]
    params = _jax_case("Discriminator")[0]
    big = jax.tree_util.tree_map(lambda a: np.asarray(a) * 40.0, params)
    for p in (params, big):  # at large scores exp overflows in both
        want = jmod.apply(p, *(jnp.asarray(a) for a in jin[:2]),
                          method=jc.Discriminator.reward)
        got = load_jax_params(tmod, p).reward(*tin[:2])
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    assert np.isinf(np.asarray(want)).any()


def test_generator_takes_no_gradient_through_the_reward():
    _, _, tmod, tin, _ = CASES["Generator"]
    model = load_jax_params(tmod, _jax_case("Generator")[0])
    reward = tin[2].clone().requires_grad_()
    model(tin[0], tin[1], reward).backward()
    assert reward.grad is None


def test_fused_gat_model_matches_jax_and_requires_its_plan():
    x, ei = _tiny()
    jplan = JaxFusedGATConv.to_graph_format(ei, N, R=8, ET=16)
    jmod = jc.FusedGATModel(hidden_dim=4, num_class=C, heads=2)
    params = jmod.init(KEY, jnp.asarray(x), jnp.asarray(ei), jplan)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(ei),
                                 jplan))
    model = load_jax_params(tc.FusedGATModel(hidden_dim=4, num_class=C,
                                             heads=2), _np_tree(params)).eval()
    plan = tc.FusedGATModel.to_graph_format(ei, N)
    got = model(_t(x), _t(ei), plan).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="requires the fused plan"):
        model(_t(x), _t(ei))


def test_amp_elbo_matches_jax():
    rng = np.random.default_rng(8)
    args = (rng.normal(size=(4, 3, 2)).astype(np.float32),
            rng.normal(size=(4, 2)).astype(np.float32),
            rng.normal(size=(1, 3)).astype(np.float32),
            rng.normal(size=(1, 3)).astype(np.float32),
            rng.normal(size=(1, 3)).astype(np.float32),
            np.float32(0.3), np.asarray([[0.2, 0.5, 0.3]], np.float32), 4.0)
    for a in (args, (args[0][..., :1], args[1][:, 0]) + args[2:],
              (args[0][..., 0], args[1][:, 0]) + args[2:]):
        want = float(jc.amp_elbo_regression_loss(*a))
        got = float(tc.amp_elbo_regression_loss(
            *(torch.as_tensor(v) if isinstance(v, np.ndarray) else v
              for v in a)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_host_facades_follow_jax():
    rng = np.random.default_rng(9)
    embs = [rng.normal(size=(10, 4)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(tc.HERec(dim=4).fit(embs),
                                  jc.HERec(dim=4).fit(embs))
    adj = (rng.random((10, 10)) < 0.3).astype(np.float32)
    text = rng.normal(size=(10, 6)).astype(np.float32)
    got = tc.TADWModel(dim=4, iters=3, device="cpu").fit(adj, text)
    want = jc.TADWModel(dim=4, iters=3).fit(adj, text)
    assert got.shape == want.shape == (10, 8)
    np.testing.assert_array_equal(
        got, tm.tadw(adj, text, dim=4, iters=3, device="cpu"))
    # tadw's steps in torch vs numpy: rtol 1e-4, as ROADMAP C38 records
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", jc.__all__[:23])
def test_alias_is_the_port_class_of_the_jax_target(name):
    target = getattr(jc, name).__name__
    assert getattr(tc, name) is getattr(tm, target)
    assert getattr(tm, name) is getattr(tc, name)


def test_dgcnn_is_seal_not_the_dgcnn_model():
    assert tm.DGCNN is tm.SEALModel
    assert tm.DGCNN is not tm.DGCNNModel


def test_every_compat_name_is_bound_once():
    import ast
    import inspect
    src = inspect.getsource(tm)
    tree = ast.parse(src)
    bound = [t.id for node in tree.body if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name)]
    assert not set(bound) & set(tc.__all__), "rebound in models/__init__"
    assert set(tc.__all__) <= set(tm.__all__)
