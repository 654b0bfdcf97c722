"""The port's wave-6 models (`models/wave6_models.py`: MAGCL, GCIL,
SFGCN, EdgePrompt, AMP and the DFAD-GNN losses) against the JAX
package's.

Each model is built in JAX with its own ``init``, carried across with
`load_jax_params`, and fed the same numpy inputs (from a seed). Outputs
and the gradients of a loss of them in every parameter are held at 1e-5
of max |out| (of each parameter's max |grad|), float32. Each JAX
reference is compiled once for the module (cached).
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
from gammagl_tpu.utils import add_self_loops as jax_add_self_loops  # noqa
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _np_tree)

import gammagl_tpu_torch.models as tm  # noqa: E402
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
    """x (N, FEAT), edges with self-loops (the trainers' graph); nodes
    N-4.. have only their self-loops."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, FEAT)).astype(np.float32)
    ei = np.stack([rng.integers(0, N, E), rng.integers(0, N - 4, E)])
    ei, _ = jax_add_self_loops(ei, num_nodes=N)
    return x, np.asarray(ei, np.int64)


X, EI = _graph()


def _t(a):
    return torch.from_numpy(np.array(a))


def _cot(shape, seed=7):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _emb(shape):
    g = _cot(shape)
    return (lambda out: jnp.sum(out * g), lambda out: (out * _t(g)).sum())


def _pair(shape):
    """A loss of (logits, scalar): sum(logits * g) + 3 * scalar."""
    g = _cot(shape)
    return (lambda out: jnp.sum(out[0] * g) + 3.0 * out[1],
            lambda out: (out[0] * _t(g)).sum() + 3.0 * out[1])


IDENT = (lambda out: out, lambda out: out)


def _knn(k=3):
    """The amgcn script's feature graph: each node to its k most similar
    other rows by the inner product."""
    sim = X @ X.T
    nn_idx = np.argsort(-sim, axis=1)[:, 1:k + 1]
    return np.stack([np.repeat(np.arange(N), k), nn_idx.reshape(-1)])


def _cases():
    x, ei = jnp.asarray(X), jnp.asarray(EI)
    tx, tei = _t(X), _t(EI)
    rng = np.random.default_rng(5)
    x2 = (X * (rng.random((1, FEAT)) > 0.3)).astype(np.float32)
    w1 = (rng.random(EI.shape[1]) > 0.2).astype(np.float32)
    w2 = (rng.random(EI.shape[1]) > 0.4).astype(np.float32)
    w1[-N:] = w2[-N:] = 1.0  # every node keeps its self-loop
    fei = _knn()
    two = (x, ei, jnp.asarray(w1), jnp.asarray(x2), ei, jnp.asarray(w2))
    ttwo = (tx, tei, _t(w1), _t(x2), tei, _t(w2))
    return {
        "magcl_loss": (jm.MAGCLModel(HID), two, tm.MAGCLModel(HID), ttwo,
                       *IDENT),
        "magcl_embed": (jm.MAGCLModel(HID), (x, ei, None),
                        tm.MAGCLModel(HID), (tx, tei, None),
                        *_emb((N, HID))),
        "magcl_k2_4": (jm.MAGCLModel(HID, tau=0.7, k_low=2, k_high=4), two,
                       tm.MAGCLModel(HID, tau=0.7, k_low=2, k_high=4), ttwo,
                       *IDENT),
        "gcil_loss": (jm.GCILModel(HID), two, tm.GCILModel(HID), ttwo,
                      *IDENT),
        "gcil_embed": (jm.GCILModel(HID), (x, ei, jnp.asarray(w1)),
                       tm.GCILModel(HID), (tx, tei, _t(w1)),
                       *_emb((N, HID))),
        "sfgcn": (jm.SFGCNModel(4, HID), (x, ei, jnp.asarray(fei)),
                  tm.SFGCNModel(4, HID), (tx, tei, _t(fei)),
                  *_pair((N, 4))),
        "edgeprompt": (jm.EdgePromptModel(4, HID, num_prompts=3), (x, ei),
                       tm.EdgePromptModel(4, HID, num_prompts=3), (tx, tei),
                       *_emb((N, 4))),
        "amp": (jm.AMPModel(4, HID, max_steps=4), (x, ei),
                tm.AMPModel(4, HID, max_steps=4), (tx, tei),
                *_pair((N, 4))),
        "amp_weighted": (jm.AMPModel(4, HID, max_steps=3, tau=0.5),
                         (x, ei, jnp.asarray(w1 * 0.5 + 0.25)),
                         tm.AMPModel(4, HID, max_steps=3, tau=0.5),
                         (tx, tei, _t(w1 * 0.5 + 0.25)), *_pair((N, 4))),
    }


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The init tree: an ``*_embed`` case takes its ``*_loss`` case's
    (the second encoder and the head exist only in the loss form)."""
    name = name.replace("_embed", "_loss")
    jmod, jin = CASES[name][:2]
    return jax.jit(jmod.init)(KEY, *jin)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's output and the gradients of its loss, compiled once."""
    jmod, jin, _, _, jloss, _ = CASES[name]
    params = _jax_init(name)

    def loss(p):
        out = jmod.apply(p, *jin)
        return jloss(out), out

    grads, out = jax.jit(jax.grad(loss, has_aux=True))(params)
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_output_and_grads_match_jax(name):
    _, _, tmod, tin, _, tloss = CASES[name]
    params, want, grads = _jax_case(name)
    model = load_jax_params(tmod, params).eval()
    model.zero_grad(set_to_none=True)
    out = model(*tin)
    tloss(out).backward()
    for got_leaf, want_leaf in zip(_leaves(out), _leaves(want)):
        _check(got_leaf, want_leaf, TOL)
    _check_grads(model, grads, TOL)


def test_edgeprompt_degree_count_is_float32_in_both_packages():
    """EdgePrompt divides by each node's in-degree, which the JAX model
    counts in h's dtype and the port in float32. h takes the promotion of
    x and the float32 kernel in both (flax's ``Dense`` promotes as the
    port's `dense` does), so with bfloat16 features too the count is
    float32 in both: a hub of 300 in-edges, where a bfloat16 count would
    stop at 256, gives JAX's output."""
    hub = np.concatenate([EI, np.stack([np.arange(300) % N,
                                        np.zeros(300, np.int64)])], 1)
    xb = jnp.asarray(X, jnp.bfloat16)
    jmod = jm.EdgePromptModel(4, HID)
    params = jax.jit(jmod.init)(KEY, xb, jnp.asarray(hub))
    want = jax.jit(jmod.apply)(params, xb, jnp.asarray(hub))
    assert want.dtype == jnp.float32
    model = load_jax_params(tm.EdgePromptModel(4, HID), _np_tree(params))
    with torch.no_grad():
        got = model(_t(X).to(torch.bfloat16), _t(hub))
    assert got.dtype == torch.float32
    _check(got, want, TOL)


def test_dfad_losses_match_jax():
    """The student loss and the generator loss, with the teacher's
    gradient cut in the student loss only."""
    s, t = _cot((20, 5), 1), _cot((20, 5), 2)
    jst = jax.grad(lambda a, b: jm.dfad_student_loss(a, b), argnums=(0, 1))
    jge = jax.grad(lambda a, b: jm.dfad_generator_loss(a, b),
                   argnums=(0, 1))
    for jfn, tfn, jgrad in ((jm.dfad_student_loss, tm.dfad_student_loss,
                             jst),
                            (jm.dfad_generator_loss, tm.dfad_generator_loss,
                             jge)):
        ts, tt = _t(s).requires_grad_(), _t(t).requires_grad_()
        loss = tfn(ts, tt)
        loss.backward()
        _check(loss, jfn(s, t), TOL)
        gs, gt = jgrad(jnp.asarray(s), jnp.asarray(t))
        _check(ts.grad, gs, TOL)
        if tfn is tm.dfad_student_loss:
            assert tt.grad is None and not np.asarray(gt).any()
        else:
            _check(tt.grad, gt, TOL)


def test_models_own_init_runs_lazy():
    """The port's own init (lazy first maps): finite outputs and losses
    that backpropagate."""
    tx, tei = _t(X), _t(EI)
    w = torch.ones(EI.shape[1])
    for model, inputs in (
            (tm.MAGCLModel(HID), (tx, tei, w, tx, tei, w)),
            (tm.GCILModel(HID), (tx, tei, w, tx, tei, w)),
            (tm.SFGCNModel(3, HID), (tx, tei, _t(_knn()))),
            (tm.EdgePromptModel(3, HID), (tx, tei)),
            (tm.AMPModel(3, HID), (tx, tei))):
        out = model(*inputs)
        loss = sum(o.sum() for o in _leaves(out))
        loss.backward()
        assert all(torch.isfinite(o).all() for o in _leaves(out))
