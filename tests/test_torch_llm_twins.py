"""The five graph-LLM twins (`gammagl_tpu_torch/examples/`: graphgpt,
llaga, llmrec, nlgraph, walklm) against the JAX scripts of
`examples/<name>/`.

Each twin has its script's flags and defaults (read from the script's
``__main__`` block by AST). From the JAX init (handed in as a flax tree)
and on the same small graph, the twin's loop gives the JAX loop's losses
over a few epochs at rtol 1e-5: graphgpt stage 1 (CLIP) and stage 2
(instruction tuning), llaga with the nd and ho templates. Their host
inputs (prompts, sentinels, labels, templates) are bitwise the script's.
The JAX loops are the scripts' steps, rebuilt here on the data handed in
and compiled once each. The three splice demos (llmrec, nlgraph, walklm)
run the JAX scripts themselves, their dataset loader patched to give the
same graph: spliced inputs at rtol 1e-5.
"""

import ast
import functools
import os.path as osp
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import examples.common as jax_common  # noqa: E402
import gammagl_tpu.models as jm  # noqa: E402
from gammagl_tpu.utils.conversation import get_conv_template  # noqa: E402
from gammagl_tpu.utils.gfm_utils import DEFAULT_GRAPH_TOKEN  # noqa: E402
from tests.test_torch_a6e_twins import _losses  # noqa: E402
from tests.test_torch_simple_convs import _np_tree  # noqa: E402
from tests.test_torch_simple_twins import _tiny_data  # noqa: E402

from gammagl_tpu_torch.examples import (  # noqa: E402
    graphgpt_trainer, llaga_trainer, llmrec_trainer, nlgraph_trainer,
    walklm_trainer)

TWINS = {"graphgpt": graphgpt_trainer, "llaga": llaga_trainer,
         "llmrec": llmrec_trainer, "nlgraph": nlgraph_trainer,
         "walklm": walklm_trainer}
EPOCHS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")


@functools.lru_cache(maxsize=None)
def _script(name):
    """The JAX script module and its command line's defaults: the
    ``base_parser(...)`` keywords and the ``add_argument`` calls of its
    source, read by AST (a flag without ``type`` is a string)."""
    import importlib
    path = osp.join(osp.dirname(__file__), "..", "examples", name,
                    f"{name}_trainer.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    overrides, extra = {}, {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
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
        kind = eval(ast.unparse(kw["type"])) if "type" in kw else str
        parser.add_argument(f"--{flag}", type=kind,
                            default=ast.literal_eval(kw["default"]))
    module = importlib.import_module(f"examples.{name}.{name}_trainer")
    return module, parser.parse_args([])


def _flags(name, **overrides):
    """(JAX script module, its args, the twin's args on the CPU) after
    checking the twin's flags and defaults are the script's."""
    jmod, jargs = _script(name)
    jargs = type(jargs)(**vars(jargs))
    targs = TWINS[name].parser().parse_args(["--device", "cpu"])
    assert {k: v for k, v in vars(targs).items() if k != "device"} == \
        vars(jargs)
    for k, v in overrides.items():
        setattr(jargs, k, v)
        setattr(targs, k, v)
    return jmod, jargs, targs


def _data():
    """A small graph whose every node has an edge in (its self-loop): a
    CLIP batch node without one has a zero embedding at init, where
    JAX's gradient of its norm is NaN (ROADMAP C51)."""
    data = dict(_tiny_data(5))
    n = data["x"].shape[0]
    loops = np.stack([np.arange(n), np.arange(n)])
    data["edge_index"] = np.concatenate(
        [np.asarray(data["edge_index"]), loops], 1).astype(np.int64)
    return data


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jnp(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_graphgpt_stage1_losses_match_jax():
    _, jargs, targs = _flags("graphgpt", n_epoch=EPOCHS)
    data = _data()
    x = np.asarray(data["x"])[:, :32]
    ei = np.asarray(data["edge_index"])
    n = x.shape[0]
    model = jm.GraphTextCLIP(embed_dim=32, gnn_hidden=32,
                             transformer_width=32, vocab_size=1000,
                             context_length=12)
    xj, eij = _jnp(x, ei)
    params = model.init(jax.random.PRNGKey(jargs.seed), xj, eij,
                        *_jnp(*graphgpt_trainer.clip_batch(0, n)))
    batches = [_jnp(*graphgpt_trainer.clip_batch(e, n))
               for e in range(EPOCHS)]
    # the script's batches, drawn as it draws them
    r = np.random.default_rng(2)
    np.testing.assert_array_equal(graphgpt_trainer.clip_batch(2, n)[0],
                                  r.integers(0, n, 8))
    want, _ = _losses(params, lambda p, nid, tok: model.apply(
        p, xj, eij, nid, tok)[0], optax.adam(jargs.lr), batches)
    adapter = jm.GraphLlamaAdapter(lm_hidden_size=64, graph_hidden_size=32)
    ap = adapter.init(jax.random.PRNGKey(0), xj, eij)
    out = graphgpt_trainer.main(targs, data=data, params=_np_tree(params),
                                adapter_params=_np_tree(ap))
    _close(out["losses"], want)
    _close(out["graph_tokens"], adapter.apply(ap, xj, eij))


def _jax_stage2_inputs(args, data):
    """The JAX script's stage-2 host inputs on ``data``."""
    rng = np.random.default_rng(args.seed)
    x = np.asarray(data["x"])[:, :16].astype(np.float32)
    y = np.asarray(data["y"])
    nodes = rng.permutation(x.shape[0])[:16]
    prompts, responses = [], []
    for v in nodes:
        conv = get_conv_template("graphchat_v1")
        conv.append_message(conv.roles[0],
                            f"Node {DEFAULT_GRAPH_TOKEN} category?")
        conv.append_message(conv.roles[1], None)
        prompts.append(conv.get_prompt()[-40:])
        responses.append(f"class {y[v]}")
    ids, labels = jm.build_stage2_batch(
        prompts, responses, lambda s: [2 + (ord(c) % 60) for c in s][:24],
        num_graph_tokens=4, max_len=64)
    return (x, np.asarray(data["edge_index"]),
            np.stack([np.full(4, v) for v in nodes]), ids, labels)


def test_graphgpt_stage2_losses_match_jax():
    _, jargs, targs = _flags("graphgpt", n_epoch=EPOCHS, stage=2)
    data = _data()
    inputs = _jnp(*_jax_stage2_inputs(jargs, data))
    model = jm.GraphLlamaLM(vocab_size=80, lm_hidden=32, graph_hidden=16,
                            lm_layers=1, max_len=64)
    params = model.init(jax.random.PRNGKey(jargs.seed), *inputs)
    want, _ = _losses(params, lambda p, *a: model.apply(p, *a)[0],
                      optax.adam(jargs.lr), [inputs] * EPOCHS)
    out = graphgpt_trainer.main(targs, data=data, params=_np_tree(params))
    for got, w in zip(out["inputs"], inputs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    _close(out["losses"], want)


def _jax_llaga_inputs(args, data):
    """The JAX script's host inputs on ``data``: (graph inputs, ids,
    labels, K)."""
    jmod = _script("llaga")[0]
    rng = np.random.default_rng(args.seed)
    x = np.asarray(data["x"])[:, :16].astype(np.float32)
    ei = np.asarray(data["edge_index"])
    y = np.asarray(data["y"])
    n = x.shape[0]
    nodes = rng.permutation(n)[:args.batch_size]
    if args.template == "nd":
        seq = jm.llaga_neighborhood_detail(ei, nodes, n, use_hop=2,
                                           sample_size=3, seed=args.seed)
        K, graph_inputs = seq.shape[1] + 4, (seq, x)
    else:
        graph_inputs, K = jm.llaga_hop_field(x, ei, nodes, num_hops=2), 3
    ids = np.zeros((len(nodes), 96), np.int32)
    labels = np.full((len(nodes), 96), -100, np.int32)
    for b, v in enumerate(nodes):
        conv = get_conv_template("llaga_llama_2")
        conv.append_message(conv.roles[0],
                            f"Node {DEFAULT_GRAPH_TOKEN} category?")
        conv.append_message(conv.roles[1], None)
        pre, _, post = conv.get_prompt()[-40:].partition(DEFAULT_GRAPH_TOKEN)
        seq_ids = (jmod.toy_tokenizer(pre) + [-200] * K
                   + jmod.toy_tokenizer(post))
        resp = jmod.toy_tokenizer(f"class {y[v]}")
        lab = [-100] * len(seq_ids) + resp
        seq_ids = (seq_ids + resp)[:96]
        ids[b, :len(seq_ids)] = seq_ids
        labels[b, :len(lab[:96])] = lab[:96]
    return graph_inputs, ids, labels, K


@pytest.mark.parametrize("template", ["nd", "ho"])
def test_llaga_losses_match_jax(template):
    jmod, jargs, targs = _flags("llaga", n_epoch=EPOCHS, template=template)
    data = _data()
    graph_inputs, ids, labels, K = _jax_llaga_inputs(jargs, data)
    got_inputs = llaga_trainer.llaga_batch(targs, data)
    assert got_inputs[3] == K
    for g, w in zip(jax.tree_util.tree_leaves(got_inputs[:3]),
                    jax.tree_util.tree_leaves((graph_inputs, ids, labels))):
        np.testing.assert_array_equal(g, w)
    gi = jax.tree_util.tree_map(jnp.asarray, graph_inputs)
    model = jmod.LLaGAModel(num_graph_tokens=K, template=template,
                            use_hop=2, sample_size=3)
    idj, labj = _jnp(ids, labels)
    params = model.init(jax.random.PRNGKey(jargs.seed), gi, idj, labj)
    want, _ = _losses(params, lambda p, g, i, lab: model.apply(p, g, i, lab),
                      optax.adam(jargs.lr), [(gi, idj, labj)] * EPOCHS)
    out = llaga_trainer.main(targs, data=data, params=_np_tree(params))
    _close(out["losses"], want)


@pytest.mark.parametrize("name", ["llmrec", "nlgraph", "walklm"])
def test_splice_demo_matches_the_jax_script(name, monkeypatch):
    jmod, jargs, targs = _flags(name)
    data = _data()
    graph = types.SimpleNamespace(x=data["x"], edge_index=data["edge_index"],
                                  y=data["y"])
    monkeypatch.setattr(jmod, "load_node_dataset",
                        lambda *a, **k: (graph, 4))
    want = jmod.main(jargs)
    x, ei = _jnp(np.asarray(data["x"])[:, :32], data["edge_index"])
    ap = jm.GraphLlamaAdapter(lm_hidden_size=64, graph_hidden_size=32).init(
        jax.random.PRNGKey(jargs.seed), x, ei)
    got = TWINS[name].main(targs, data=data, params=_np_tree(ap))
    _close(got, want)
    assert TWINS[name].INSTRUCTION in open(jmod.__file__).read()
