"""The A6d utilities of the port (`gammagl_tpu_torch/typing.py`,
`utils/compat_utils.py`, `profiling.py`, `paths_io.py`, `smiles.py`,
`conversation.py`, `gfm_utils.py` and `utils/__init__.py`'s exports)
against the JAX package.

Host numpy functions are held bitwise: the few-shot split (the same
`RandomState` draws), `node_subgraph`, the BFS path dicts, the simple
paths, the embedding files (each package reads the other's bit for bit)
and every conversation template's prompt. `set_device` picks a torch
device by the JAX package's out-of-range rule and raises without a card
unless the CPU is asked for. `profiling` cannot be held to JAX's numbers:
its contract is tested (calls, a trace file, one line a bracket).
`from_smiles` needs rdkit, which this environment lacks: both packages
are held to the same ImportError.
"""

import os
import sys

import numpy as np
import pytest
import torch

from gammagl_tpu import typing as jax_typing
from gammagl_tpu.data import BatchGraph as JaxBatch
from gammagl_tpu.data import Graph as JaxGraph
from gammagl_tpu.utils import compat_utils as jcu
from gammagl_tpu.utils import conversation as jconv
from gammagl_tpu.utils import gfm_utils as jgfm
from gammagl_tpu.utils import paths_io as jpio
from gammagl_tpu.utils import smiles as jsmiles

import gammagl_tpu_torch.utils as tu
from gammagl_tpu_torch import typing as port_typing
from gammagl_tpu_torch.data import BatchGraph, Graph
from gammagl_tpu_torch.ops import segment_softmax
from gammagl_tpu_torch.utils import compat_utils as cu
from gammagl_tpu_torch.utils import conversation as conv
from gammagl_tpu_torch.utils import gfm_utils, paths_io, profiling, smiles


def _graph(seed=0, n=14, e=30, f=3):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e))
    x = rng.normal(size=(n, f)).astype(np.float32)
    return ei, x


def test_typing_aliases_follow_jax():
    assert port_typing.__all__ == jax_typing.__all__
    assert port_typing.Array is torch.Tensor
    for name in ("NodeType", "EdgeType", "Metadata"):
        assert getattr(port_typing, name) == getattr(jax_typing, name)


def test_utils_exports_the_jax_names():
    import ast
    import gammagl_tpu.utils as ju
    assert set(ju.__all__) <= set(tu.__all__)
    assert tu.segment_softmax is segment_softmax
    assert tu.gfm_utils is gfm_utils
    src = open(profiling.__file__).read() + open(cu.__file__).read()
    imports = [n for n in ast.walk(ast.parse(src))
               if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("jax" in ast.unparse(n) for n in imports)


def test_sparse_helpers_match_jax():
    ei, _ = _graph(1)
    w = np.random.default_rng(2).random(ei.shape[1])
    for weights in (None, w):
        a = cu.calc_A_norm_hat(ei, weights).toarray()
        b = jcu.calc_A_norm_hat(ei, weights).toarray()
        np.testing.assert_array_equal(a, b)
    a = cu.edge_index_to_adj_matrix(ei, 14, 16)
    b = jcu.edge_index_to_adj_matrix(ei, 14, 16)
    assert a.format == b.format == "csc"
    np.testing.assert_array_equal(a.toarray(), b.toarray())


@pytest.mark.parametrize("shots,ratio,state", [(2, 0.2, 0), (5, 0.5, 3),
                                               (40, 1.0, 7)])
def test_few_shot_split_is_jax_bitwise(shots, ratio, state):
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 5, 90)
    labels[labels == 4] = 3  # a class with fewer nodes than shots
    labels[:2] = 4
    got = cu.get_few_shot_split(labels, shots, ratio, state)
    want = jcu.get_few_shot_split(labels, shots, ratio, state)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="test_ratio"):
        cu.get_few_shot_split(labels, shots, 0.0)


def test_node_subgraph_is_jax_bitwise():
    ei, x = _graph(5)
    for node, hops in ((0, 1), (3, 2), (9, 3)):
        got = cu.node_subgraph(Graph(x=x, edge_index=ei), node, hops)
        want = jcu.node_subgraph(JaxGraph(x=x, edge_index=ei), node, hops)
        assert got.num_nodes == want.num_nodes
        assert got.target_node == want.target_node
        for key in ("x", "edge_index", "subset"):
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]))


def test_shortest_path_dicts_are_jax():
    graphs = [_graph(s, n=6 + s, e=9 + 2 * s) for s in range(3)]
    ei, _ = graphs[0]
    assert (cu.shortest_path_distance(Graph(edge_index=ei, num_nodes=6))
            == jcu.shortest_path_distance(JaxGraph(edge_index=ei,
                                                   num_nodes=6)))
    port = BatchGraph.from_data_list([Graph(x=x, edge_index=e)
                                      for e, x in graphs])
    jax_b = JaxBatch.from_data_list([JaxGraph(x=x, edge_index=e)
                                     for e, x in graphs])
    assert (cu.batched_shortest_path_distance(port)
            == jcu.batched_shortest_path_distance(jax_b))


def test_set_device_rules(monkeypatch):
    """JAX's rule: an id outside the visible devices picks device 0 (held
    against `gammagl_tpu`'s own pick among its CPU devices). The port:
    ``platform="cpu"`` is the host; else a card, or a raise."""
    import jax
    before = jax.config.jax_default_device
    try:
        jax_devs = jax.devices("cpu")
        for i in (1, 99, -1):
            want = jcu.set_device(i, "cpu")
            assert want == jax_devs[i if 0 <= i < len(jax_devs) else 0]
    finally:
        jax.config.update("jax_default_device", before)
    assert cu.set_device(3, platform="cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cu.set_device()
    with pytest.raises(ValueError, match="platform"):
        cu.set_device(0, "tpu")
    picked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    assert [cu.set_device(i).index for i in (1, 2, -1, 0)] == [1, 0, 0, 0]
    assert picked == [torch.device("cuda", i) for i in (1, 0, 0, 0)]


def test_chain_time_contract():
    calls = []

    def step(h):
        calls.append(h.shape)
        return h @ torch.full((4, 4), 0.5) + 1.0

    t = profiling.chain_time(step, torch.ones(8, 4), K=5, reps=3)
    assert len(calls) == 5 * (3 + 1)
    assert np.isfinite(t) and t > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "tb"
    with profiling.trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(prof.trace_path) == str(logdir)
    import json
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in ev.get("name", "") for ev in events)


def test_device_timer_sends_one_line():
    lines = []
    with profiling.device_timer("step", sink=lines.append):
        torch.ones(3).sum()
    assert len(lines) == 1 and lines[0].startswith("step: ")
    assert lines[0].endswith("s") and float(lines[0][6:-1]) >= 0


def test_simple_paths_match_jax():
    rng = np.random.default_rng(8)
    ei = rng.integers(0, 7, (2, 20))
    for src, dst, m in ((0, 5, 4), (2, 2, 3), (1, 6, 6), (3, 0, 2)):
        assert (paths_io.find_all_simple_paths(ei, src, dst, m)
                == jpio.find_all_simple_paths(ei, src, dst, m))
    for fn in (paths_io.find_all_simple_paths, jpio.find_all_simple_paths):
        with pytest.raises(IndexError):  # no edges: no node 0 in either
            fn(np.zeros((2, 0), int), 0, 1, 3)


def test_embedding_files_cross_read_bitwise(tmp_path):
    emb = np.random.default_rng(9).normal(size=(11, 5)).astype(np.float32)
    port_file, jax_file = str(tmp_path / "p.txt"), str(tmp_path / "j.txt")
    paths_io.save_embeddings(port_file, torch.from_numpy(emb))
    jpio.save_embeddings(jax_file, emb)
    assert open(port_file).read() == open(jax_file).read()
    for path in (port_file, jax_file):
        for nodes in (None, 15):
            a = paths_io.read_embeddings(path, nodes)
            b = jpio.read_embeddings(path, nodes)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_inspector_routes_kwargs_as_jax():
    def message(self, x_j, edge_weight=None, scale=2.0):
        return x_j

    def update(aggr_out, bias=1):
        return aggr_out

    port, ref = paths_io.Inspector(object), jpio.Inspector(object)
    for ins in (port, ref):
        ins.inspect(message, pop_first=True).inspect(update)
    assert port.keys() == ref.keys()
    assert port.keys(["update"]) == ref.keys(["update"])
    kw = {"edge_weight": 3, "bias": 4, "other": 5}
    for name in ("message", "update", "missing"):
        assert port.distribute(name, kw) == ref.distribute(name, kw)


def test_from_smiles_without_rdkit_raises_as_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "rdkit", None)
    for fn in (smiles.from_smiles, jsmiles.from_smiles):
        with pytest.raises(ImportError, match="from_smiles requires rdkit"):
            fn("CCO")
    assert smiles.ATOM_FEATURES == jsmiles.ATOM_FEATURES


def _messages(c, graph):
    first = ("Describe <graph> please.", "payload") if graph else "Hi."
    return [[c.roles[0], first], [c.roles[1], "A reply."],
            [c.roles[0], "More?"], [c.roles[1], None]]


@pytest.mark.parametrize("name", sorted(jconv.conv_templates))
def test_every_conversation_template_renders_jax_prompts(name):
    for graph in (False, True):
        got, want = (mod.get_conv_template(name)
                     for mod in (conv, jconv))
        for c in (got, want):
            for role, msg in _messages(c, graph):
                c.append_message(role, msg)
        assert got.get_prompt() == want.get_prompt()
        assert got.copy().dict() == want.copy().dict()
    assert conv.conv_templates[name].messages == []
    assert conv.default_conversation.get_prompt() == \
        jconv.default_conversation.get_prompt()


class _Tok:
    """A tokenizer stand-in: a word a token, ids by a fixed vocabulary."""

    class _Out:
        def __init__(self, ids):
            self.input_ids = ids

    def __call__(self, text, add_special_tokens=True):
        ids = [len(w) * 7 + ord(w[0]) for w in text.split()]
        return self._Out(([1] if add_special_tokens else []) + ids)

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids)


def test_gfm_utils_match_jax():
    for name in jgfm.__all__:
        if name.isupper():
            assert getattr(gfm_utils, name) == getattr(jgfm, name)
    prompt = "Look at <graph> and <graph> now."
    assert (gfm_utils.tokenizer_graph_token(prompt, _Tok())
            == jgfm.tokenizer_graph_token(prompt, _Tok()))
    for keywords, start in ((["w3"], 0), (["w5", "w9"], 2), (["zz"], 0)):
        a = gfm_utils.KeywordsStoppingCriteria(keywords, _Tok(), start)
        b = jgfm.KeywordsStoppingCriteria(keywords, _Tok(), start)
        for ids in ([1, 3, 5], [9, 9], []):
            assert a(ids) == b(ids)
