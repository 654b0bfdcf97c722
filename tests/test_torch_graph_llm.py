"""The port's `models/graph_llm.py` against the JAX package's.

Each module is built in JAX with its own ``init``, carried across with
`load_jax_params` and fed the same numpy inputs (from a seed): outputs
and losses at rtol 1e-5, atol 1e-6; the gradients of a loss of them (the
training loss where the module has one: step-0 gradients) in every
parameter at rtol 1e-4, atol 1e-6 plus 1e-5 of that parameter's largest
gradient (float32: the token embeddings' gradients are sums over
positions, and their small entries cancel, so they move with the sum
order by ~2e-6 of the largest), each JAX reference compiled once for the
module. The host parts (`splice_graph_embeddings`,
`build_stage2_batch`, `llaga_hop_field`, `llaga_neighborhood_detail`)
are bitwise. The flax defaults the port keeps (LayerNorm epsilon 1e-6,
tanh GELU, masked scores at finfo min) and the negative sentinels
(ROADMAP C48-C50) are pinned here too.
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
import gammagl_tpu.models.graph_llm as jgl  # noqa: E402
from gammagl_tpu.utils.gfm_utils import (  # noqa: E402
    DEFAULT_GRAPH_PAD_ID, GRAPH_TOKEN_INDEX, IGNORE_INDEX)
from tests.test_torch_a6e_models import (  # noqa: E402
    _close, _cot, _dot, _leaves, _t, _torch_leaves)
from tests.test_torch_simple_convs import _flat, _np_tree  # noqa: E402

import gammagl_tpu_torch.models.graph_llm as tgl  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402
from gammagl_tpu_torch.utils.params import _layout  # noqa: E402

KEY = jax.random.PRNGKey(11)
N, FEAT = 20, 6


def _grads_close(module, jax_grads):
    """The port's parameter gradients under their flax names (kernels
    transposed back; one the loss does not reach is zeros, as in JAX)
    against jax.grad's: rtol 1e-4, atol 1e-6 + 1e-5 of the parameter's
    largest |grad|."""
    want = dict(_flat(jax_grads["params"]))
    got = {}
    for path, (p, perm) in _layout(module).items():
        g = (np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.detach().numpy())
        got["/".join(path)] = g.transpose(perm) if perm else g
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        _close(got[name], w, 1e-4, 1e-6 + 1e-5 * float(np.abs(w).max()))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graph(seed=0, n=N, e=60):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
    return _cot((n, FEAT), seed + 1), ei.astype(np.int64)


def _stage2_inputs(seed=3, B=3, L=12, K=2, V=30):
    """A batch with K sentinels a row, prompt labels ignored, and a last
    row whose labels are all ignored (the masked mean's edge)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, L))
    labels = np.full((B, L), IGNORE_INDEX)
    for b in range(B):
        ids[b, 2 + b:2 + b + K] = GRAPH_TOKEN_INDEX
        if b < B - 1:
            labels[b, 7:] = rng.integers(0, V, L - 7)
    return ids, labels, rng.integers(0, N, (B, K))


def _cases():
    x, ei = _graph()
    # nodes with edges in: a node without any has a zero embedding at
    # init, where the norm's gradient is NaN in both packages
    nid = np.unique(ei[1])[[0, 3, 5, -1]]
    tokens = np.random.default_rng(2).integers(0, 30, (4, 6))
    ids, labels, node_ids = _stage2_inputs()
    hop = _cot((5, 3, FEAT), 4)
    seq = tgl.llaga_neighborhood_detail(ei, [1, 4, 9], N, use_hop=2,
                                        sample_size=3, seed=5)
    assert (seq == DEFAULT_GRAPH_PAD_ID).any()
    lm_ids = np.random.default_rng(6).integers(0, 30, (2, 7))

    def step_loss(out):  # the training loss: step-0 gradients
        return out[0]

    def dot_of(shape, seed):
        return lambda out: _dot(out, _cot(shape, seed))

    clip = dict(embed_dim=8, gnn_hidden=8, transformer_width=16,
                transformer_layers=2, transformer_heads=4, vocab_size=30,
                context_length=6)
    s2 = dict(vocab_size=30, lm_hidden=16, graph_hidden=8, lm_layers=2,
              max_len=12)
    return {
        "clip": (jgl.GraphTextCLIP(**clip), (x, ei, nid, tokens),
                 tgl.GraphTextCLIP(**clip),
                 (_t(x), _t(ei), _t(nid), _t(tokens)), step_loss),
        "adapter": (jgl.GraphLlamaAdapter(16, 8), (x, ei),
                    tgl.GraphLlamaAdapter(16, 8), (_t(x), _t(ei)),
                    dot_of((N, 16), 10)),
        "llaga_encoder": (jgl.LLaGAEncoder(16), (hop,),
                          tgl.LLaGAEncoder(16), (_t(hop),),
                          dot_of((5, 3, 16), 11)),
        "tiny_lm": (jgl.TinyCausalLM(30, 16, 2, 4, 10), (lm_ids,),
                    tgl.TinyCausalLM(30, 16, 2, 4, 10), (_t(lm_ids),),
                    dot_of((2, 7, 30), 12)),
        "graph_llama_lm": (jgl.GraphLlamaLM(**s2),
                           (x, ei, node_ids, ids, labels),
                           tgl.GraphLlamaLM(**s2),
                           (_t(x), _t(ei), _t(node_ids), _t(ids),
                            _t(labels)), step_loss),
        "llaga_projector": (jgl.LLaGAProjector(16), (seq, x),
                            tgl.LLaGAProjector(16), (_t(seq), _t(x)),
                            dot_of((3, 17, 16), 13)),
    }


CASES = _cases()


@functools.lru_cache(maxsize=None)
def _jax_fn(name):
    """The case's init tree and its loss's gradients and output as one
    compiled function of (params, *inputs)."""
    jmod, jin, _, _, loss_of = CASES[name]
    params = jmod.init(KEY, *(jnp.asarray(a) for a in jin))

    def loss(p, *a):
        out = jmod.apply(p, *a)
        return loss_of(out), out

    return params, jax.jit(jax.grad(loss, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The case's init tree, output and the gradients of its loss."""
    params, fn = _jax_fn(name)
    grads, out = fn(params, *(jnp.asarray(a) for a in CASES[name][1]))
    return (_np_tree(params), jax.tree_util.tree_map(np.asarray, out),
            grads)


@pytest.mark.parametrize("name", sorted(CASES))
def test_module_output_loss_and_grads_match_jax(name):
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


def test_text_tower_follows_flax_construction_order():
    """Dense_0 is the feed-forward's outer (4w, w) map and Dense_1 its
    inner (w, 4w) one; LayerNorm_4 is the final norm (C48)."""
    params = _jax_case("clip")[0]["params"]["_TextTransformer_0"]
    assert params["Dense_0"]["kernel"].shape == (64, 16)
    assert params["Dense_1"]["kernel"].shape == (16, 64)
    assert "LayerNorm_4" in params and "LayerNorm_5" not in params
    tower = CASES["clip"][2].text
    assert tower.norms[-1].eps == 1e-6
    assert tuple(tower.flax_tree()["Dense_0"].weight.shape) == (16, 64)


def test_masked_scores_take_finfo_min_and_gelu_is_tanh():
    """flax fills masked scores with finfo min (a fully masked row is
    uniform, not NaN) and its gelu is the tanh form (C48)."""
    from flax import linen as fnn
    from gammagl_tpu_torch.models.spectral import _SelfAttention
    rng = np.random.default_rng(14)
    h = _cot((2, 5, 8), 15)
    mask = np.zeros((2, 1, 5, 5), bool)
    mask[0] = np.tril(np.ones((5, 5), bool))
    jatt = fnn.SelfAttention(num_heads=2, qkv_features=8, deterministic=True)
    p = jatt.init(KEY, jnp.asarray(h), mask=jnp.asarray(mask))
    want = jatt.apply(p, jnp.asarray(h), mask=jnp.asarray(mask))
    att = load_jax_params(_SelfAttention(8, 2), _np_tree(p))
    got = att(_t(h), mask=_t(mask))
    _close(got, want)
    assert torch.isfinite(got).all()
    z = rng.normal(size=50).astype(np.float32) * 3
    _close(tgl._gelu(_t(z)), jax.nn.gelu(z))


def test_splice_is_jax_bitwise():
    rng = np.random.default_rng(16)
    ids = rng.integers(0, 9, 10)
    ids[[2, 3, 7]] = GRAPH_TOKEN_INDEX
    te, ge = _cot((10, 4), 17), _cot((3, 4), 18)
    want = np.asarray(jgl.splice_graph_embeddings(ids, jnp.asarray(te),
                                                  jnp.asarray(ge)))
    got = tgl.splice_graph_embeddings(_t(ids), _t(te), _t(ge)).numpy()
    np.testing.assert_array_equal(got, want)
    # a batch, with fewer embeddings than sentinels (the slot clips)
    ids2 = np.stack([ids, np.roll(ids, 3)])
    te2, ge2 = _cot((2, 10, 4), 19), _cot((2, 2, 4), 20)
    want2 = jax.vmap(jgl.splice_graph_embeddings)(
        jnp.asarray(ids2), jnp.asarray(te2), jnp.asarray(ge2))
    got2 = tgl.splice_graph_embeddings(_t(ids2), _t(te2), _t(ge2))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


def test_host_templates_and_batches_are_jax_bitwise():
    x, ei = _graph(21, n=30, e=50)
    nodes = [0, 5, 17, 29]
    np.testing.assert_array_equal(
        tgl.llaga_hop_field(x, ei, nodes, num_hops=3),
        jgl.llaga_hop_field(x, ei, nodes, num_hops=3))
    for hop, s in ((2, 3), (1, 4), (3, 2)):
        want = jgl.llaga_neighborhood_detail(ei, nodes, 30, use_hop=hop,
                                             sample_size=s, seed=22)
        got = tgl.llaga_neighborhood_detail(ei, nodes, 30, use_hop=hop,
                                            sample_size=s, seed=22)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def tok(s):
        return [2 + (ord(c) % 60) for c in s][:24]

    prompts = ["Node <graph> kind?", "no graph here", "x <graph>"]
    responses = ["class 3", "a long answer " * 4, ""]
    for K, L in ((4, 40), (2, 12)):
        got = tgl.build_stage2_batch(prompts, responses, tok, K, L)
        want = jgl.build_stage2_batch(prompts, responses, tok, K, L)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_all_ignored_labels_give_zero_loss_not_nan():
    """The masked mean divides by max(kept, 1): a batch whose labels are
    all ignored has loss 0, in JAX and here (C50)."""
    jmod, jin, tmod, tin, _ = CASES["graph_llama_lm"]
    params = _jax_case("graph_llama_lm")[0]
    labels = np.full_like(jin[4], IGNORE_INDEX)
    want, _ = jmod.apply(params, *(jnp.asarray(a) for a in jin[:4]),
                         jnp.asarray(labels))
    model = load_jax_params(tmod, params)
    got, _ = model(*tin[:4], _t(labels))
    assert float(want) == 0.0 and float(got) == 0.0


def test_clip_zero_embedding_gradient_differs_on_purpose():
    """A CLIP batch node without edges in has a zero embedding at init:
    JAX's gradient of its norm is NaN there, the port's gradient is
    finite (the 1e-8 guard divides a zero; C51, as C35)."""
    x, ei = _graph()
    lonely = int(np.setdiff1d(np.arange(N), ei[1])[0])
    nid = np.asarray([lonely, *np.unique(ei[1])[:3]])
    tokens = np.random.default_rng(2).integers(0, 30, (4, 6))
    tmod = CASES["clip"][2]
    params = _jax_case("clip")[0]
    grads, _ = _jax_fn("clip")[1](
        params, *(jnp.asarray(a) for a in (x, ei, nid, tokens)))
    assert np.isnan(np.asarray(
        grads["params"]["GCNConv_1"]["bias"])).any()
    model = load_jax_params(tmod, params)
    model.zero_grad(set_to_none=True)
    loss, (g_emb, _) = model(*(_t(a) for a in (x, ei, nid, tokens)))
    assert float(g_emb[0].abs().max()) == 0.0
    loss.backward()
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.grad is not None)
