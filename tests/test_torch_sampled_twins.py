"""The sampled GraphSAGE path of the port against the JAX package: the
model on padded sampled blocks, the four twins (`serving_demo`,
`sage_sample_trainer`, `gpu_sage_trainer`, `neighbor_sampler`) and
`Reddit`.

The JAX scripts keep their padding helpers inside ``main``; the tests
take them from the scripts' source (by AST) and hold the twins' helpers
against them bitwise. The JAX trainers' loops run here on one bucket
shape each (graphs small enough that every batch pads to the first
bucket), so each JAX step compiles once; the twins start from the JAX
init through `load_jax_params`, dropout off, and give its losses at rtol
1e-5.
"""

import ast
import os
import os.path as osp
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import examples.common as jax_common  # noqa: E402
from gammagl_tpu import loader as jl  # noqa: E402
from gammagl_tpu.data import Graph as JaxGraph  # noqa: E402
from gammagl_tpu.data.padding import size_bucket as jax_size_bucket  # noqa
from gammagl_tpu.datasets import Reddit as JaxReddit  # noqa: E402
from gammagl_tpu.layers.conv import SAGEConv as JaxSAGEConv  # noqa: E402
from gammagl_tpu.models import GraphSAGEModel as JaxSAGEModel  # noqa: E402
from gammagl_tpu.models import GraphSAGESampleModel as JaxSampleModel  # noqa
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from tests.test_torch_simple_convs import (_check, _check_grads,  # noqa
                                           _jax_out_and_grads, _np_tree)
from tests.test_torch_sampler import pin_jax_sampler_lib  # noqa: E402

from gammagl_tpu_torch.data import Graph  # noqa: E402
from gammagl_tpu_torch.datasets import Reddit  # noqa: E402
from gammagl_tpu_torch.examples import (gpu_sage_trainer,  # noqa: E402
                                        neighbor_sampler, sage_sample_trainer,
                                        serving_demo)
from gammagl_tpu_torch.layers.conv import SAGEConv  # noqa: E402
from gammagl_tpu_torch.loader import NeighborSamplerLoader  # noqa: E402
from gammagl_tpu_torch.models import GraphSAGESampleModel  # noqa: E402
from gammagl_tpu_torch.utils import load_jax_params  # noqa: E402

ROOT = osp.join(osp.dirname(__file__), "..")
SCRIPTS = {
    "sage_sample": "examples/graphsage/sage_sample_trainer.py",
    "gpu_sage": "examples/gpu_sage/gpu_sage_trainer.py",
    "serving": "examples/serving/serving_demo.py",
    "sampler": "examples/sampler/neighbor_sampler.py",
}
TWINS = {"sage_sample": sage_sample_trainer, "gpu_sage": gpu_sage_trainer,
         "serving": serving_demo, "sampler": neighbor_sampler}
N, F, C = 90, 8, 4


@pytest.fixture(scope="module", autouse=True)
def jax_sampler_lib(tmp_path_factory):
    """The JAX package's sampler, built for this module, so its loaders
    never fall to their numpy routes (ROADMAP C30,
    `tests/test_torch_sampler.py`)."""
    mp = pytest.MonkeyPatch()
    yield pin_jax_sampler_lib(tmp_path_factory.mktemp("jax_sampler"), mp)
    mp.undo()


def _tree(path):
    with open(osp.join(ROOT, path)) as f:
        return ast.parse(f.read())


def _jax_nested(script, outer, name, **namespace):
    """The function ``name`` defined inside ``outer`` of a JAX script,
    compiled on its own with ``namespace`` as its globals."""
    for node in ast.walk(_tree(SCRIPTS[script])):
        if isinstance(node, ast.FunctionDef) and node.name == outer:
            for sub in ast.walk(node):
                if isinstance(sub, ast.FunctionDef) and sub.name == name:
                    ns = {"np": np, "size_bucket": jax_size_bucket,
                          "jnp": jnp, **namespace}
                    exec(compile(ast.Module([sub], []), SCRIPTS[script],
                                 "exec"), ns)
                    return ns[name]
    raise LookupError(f"{outer}.{name} not in {SCRIPTS[script]}")


def _jax_defaults(script):
    """{flag: default} of a JAX script's command line, read by AST: its
    ``base_parser(...)`` overrides and every ``add_argument`` call."""
    out = {}
    for node in ast.walk(_tree(SCRIPTS[script])):
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "id", getattr(node.func, "attr", None))
        if name == "base_parser":
            overrides = {k.arg: ast.literal_eval(k.value)
                         for k in node.keywords}
            out.update(vars(jax_common.base_parser(**overrides)
                            .parse_args([])))
        elif name == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            dest = ast.literal_eval(node.args[0]).lstrip("-")
            out[dest] = (ast.literal_eval(kw["default"]) if "default" in kw
                         else None)
    return out


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_flags_are_the_scripts(name):
    args = TWINS[name].parser().parse_args([])
    got = {k: v for k, v in vars(args).items() if k != "device"}
    assert got == _jax_defaults(name)
    if name != "sampler":  # a host benchmark: nothing runs on the card
        assert args.device == "cuda"


def _graph(n=N, deg=None, seed=0, f=F, c=C):
    """Labels planted in the features; ``deg`` in-edges a node (None:
    random ones, some nodes without)."""
    rng = np.random.default_rng(seed)
    if deg is None:
        ei = np.stack([rng.integers(0, n, 4 * n),
                       rng.integers(0, n - 10, 4 * n)])
    else:
        ei = np.stack([rng.integers(0, n, deg * n),
                       np.repeat(np.arange(n), deg)])
    y = rng.integers(0, c, n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[np.arange(n), y] += 2.0
    mask = rng.random(n) < 0.7
    return {"x": x, "edge_index": ei, "y": y, "train_mask": mask,
            "test_mask": ~mask}


def test_padding_helpers_are_the_scripts():
    """The twins' padding of a sample, bitwise the JAX scripts' nested
    helpers (sage_sample's `pad_batch_ids`, serving's `pad_block` and the
    micro phase's worst-case `pad_block`, gpu_sage's `pad_batch`)."""
    d = _graph()
    loader = NeighborSamplerLoader(d["edge_index"], sample_lists=[3, 2],
                                   batch_size=8, num_nodes=N, seed=0)
    tot = 1 + 3 + 3 * 2
    for seeds in (np.arange(8), np.array([85, 86, 3])):
        sample = loader.sample(seeds)
        for port, jax_fn in (
                (sage_sample_trainer.pad_batch_ids,
                 _jax_nested("sage_sample", "main", "pad_batch_ids")),
                (serving_demo.pad_block,
                 _jax_nested("serving", "main", "pad_block")),
                (lambda *s: serving_demo.micro_pad_block(*s, (3, 2)),
                 _jax_nested("serving", "micro_demo", "pad_block",
                             tot=tot))):
            got, want = port(*sample), jax_fn(*sample)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[2] == want[2]
            for a, b in zip(got[1], want[1]):
                np.testing.assert_array_equal(a, b)
    from gammagl_tpu_torch.loader import NodeNeighborLoader
    sub = next(iter(NodeNeighborLoader(Graph(**d), [8, 4], batch_size=8,
                                       seed=0)))
    got = gpu_sage_trainer.pad_batch(sub)
    want = _jax_nested("gpu_sage", "main", "pad_batch")(sub)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_padded_destinations_drop_out_of_the_mean():
    """SAGEConv((x, x[:size_dst])) on a block padded past size_dst: row 0
    has 2 real in-edges and 5 padded ones (dst = size_dst, out of range),
    row 2 none; each row's mean counts its real edges only, as JAX's."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, F)).astype(np.float32)
    size_dst = 4
    ei = np.array([[5, 6, 7, 8, 9, 10, 11, 4, 5],
                   [0, 0, 4, 4, 4, 4, 4, 1, 3]])
    jconv = JaxSAGEConv(6)
    params = jconv.init(jax.random.PRNGKey(0), (jnp.asarray(x),
                        jnp.asarray(x[:size_dst])), jnp.asarray(ei),
                        num_nodes=size_dst)
    want = jconv.apply(params, (jnp.asarray(x), jnp.asarray(x[:size_dst])),
                       jnp.asarray(ei), num_nodes=size_dst)
    conv = load_jax_params(SAGEConv(F, 6), _np_tree(params))
    xt = torch.from_numpy(x)
    got = conv((xt, xt[:size_dst]), torch.from_numpy(ei), num_nodes=size_dst)
    _check(got, want, 1e-6)
    # the neighbour term of row 0 is the mean of its 2 real sources
    w = conv.lin_neigh.weight.detach().numpy()
    neigh = np.zeros((size_dst, 6), np.float32)
    neigh[0] = (x[5] + x[6]) / 2 @ w.T
    neigh[1], neigh[3] = x[4] @ w.T, x[5] @ w.T
    self_part = (x[:size_dst] @ conv.lin_self.weight.detach().numpy().T
                 + conv.bias.detach().numpy())
    np.testing.assert_allclose(got.detach().numpy(), neigh + self_part,
                               rtol=1e-5, atol=1e-6)


def _sampled_batch(d, seeds, fanouts=(3, 2)):
    loader = NeighborSamplerLoader(d["edge_index"], sample_lists=fanouts,
                                   num_nodes=N, seed=3)
    n_id_p, eis, sizes = sage_sample_trainer.pad_batch_ids(
        *loader.sample(seeds))
    return d["x"][n_id_p], eis, sizes


def test_sampled_model_on_padded_blocks_matches_jax():
    """GraphSAGESampleModel on a sampled, bucket-padded batch (layer 1's
    size_dst is bucketed past its real rows): forward and the gradients of
    every parameter and of x at f32 1e-5, parameters from the JAX init."""
    d = _graph()
    x, eis, sizes = _sampled_batch(d, np.arange(6))
    assert sizes[0] == 64 and sizes[1] == 6 and eis[0].max() == 64
    jmodel = JaxSampleModel(hidden_dim=16, num_class=C, num_layers=2,
                            drop_rate=0.0)
    jadjs = [(jnp.asarray(e), s) for e, s in zip(eis, sizes)]
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x), jadjs)
    cot = np.random.default_rng(4).normal(size=(6, C)).astype(np.float32)
    out, (gp, gx) = _jax_out_and_grads(
        lambda p, xx: jmodel.apply(p, xx, jadjs),
        lambda o: jnp.sum(o * cot), params, jnp.asarray(x), argnums=(0, 1))
    model = load_jax_params(GraphSAGESampleModel(16, C, drop_rate=0.0),
                            _np_tree(params))
    xt = torch.from_numpy(x).requires_grad_()
    got = model(xt, [(torch.from_numpy(e), s) for e, s in zip(eis, sizes)])
    (got * torch.from_numpy(cot)).sum().backward()
    _check(got, out, 1e-5)
    _check(xt.grad, gx, 1e-5)
    _check_grads(model, gp, 1e-5)


def _args(module, *argv):
    return module.parser().parse_args(["--device", "cpu", *argv])


def _jax_sage_sample_losses(d, args, n_steps):
    """The JAX script's loop (`sage_sample_trainer.main`): its loader and
    init sample, its padding, Adam on the mean cross-entropy, batches
    shorter than --batch_size skipped; returns (losses, initial flax
    variables)."""
    train_idx = np.nonzero(d["train_mask"])[0]
    loader = jl.NeighborSamplerLoader(
        d["edge_index"], node_idx=train_idx,
        sample_lists=[args.fanout1, args.fanout2],
        batch_size=args.batch_size, num_nodes=N, shuffle=True,
        seed=args.seed, presample_chunks=args.presample_chunks)
    pad = _jax_nested("sage_sample", "main", "pad_batch_ids")
    model = JaxSampleModel(hidden_dim=args.hidden_dim, num_class=C,
                           num_layers=2, drop_rate=args.drop_rate)
    n_id_p, eis, sizes = pad(*loader.sample(train_idx[:args.batch_size]))
    key = jax.random.PRNGKey(args.seed)
    params = model.init({"params": key, "dropout": key},
                        jnp.asarray(d["x"][n_id_p]),
                        list(zip([jnp.asarray(e) for e in eis], sizes)))
    state = JaxTrainState.create(params=params, tx=optax.adam(args.lr))
    shape = None

    @jax.jit
    def step(state, feats, e0, e1, y):
        def loss_fn(p):
            logits = model.apply(p, feats, list(zip((e0, e1), shape)))
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    losses = []
    for bs, n_id, adjs in loader:
        if bs < args.batch_size:
            continue
        n_id_p, eis, sizes = pad(bs, n_id, adjs)
        shape = shape or sizes
        assert sizes == shape  # one bucket: one compile
        state, loss = step(state, jnp.asarray(d["x"][n_id_p]), *eis,
                           jnp.asarray(d["y"][n_id[:bs]]))
        losses.append(float(loss))
        if len(losses) == n_steps:
            return losses, params
    raise AssertionError("too few batches")


def test_sage_sample_twin_matches_the_jax_trainer():
    d = _graph()
    args = _args(sage_sample_trainer, "--batch_size", "4", "--fanout1", "3",
                 "--fanout2", "2", "--drop_rate", "0", "--n_epoch", "1")
    want, params = _jax_sage_sample_losses(d, args, 3)
    out = sage_sample_trainer.main(args, data=(Graph(**d), C),
                                   params=_np_tree(params), steps=3)
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    assert 0.0 <= out["test_acc"] <= 1.0 and len(out["step_ms"]) == 3


def test_sage_sample_twin_trains_with_dropout_and_replays(capsys):
    """Its own init, dropout, the epoch cache and the prefetch thread."""
    d = _graph()
    args = _args(sage_sample_trainer, "--batch_size", "8", "--fanout1", "3",
                 "--fanout2", "2", "--n_epoch", "3", "--resample_every",
                 "2", "--prefetch", "1")
    out = sage_sample_trainer.main(args, data=(Graph(**d), C))
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) >= 15
    assert out["cache"].misses == 0 and out["cache"].hits > 0
    assert "test acc" in capsys.readouterr().out


def test_sage_sample_falls_back_without_files(tmp_path, monkeypatch,
                                              capsys):
    """No staged Reddit: JAX's warning line and the synthetic graph,
    array for array the JAX script's; nothing fetched."""
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    args = _args(sage_sample_trainer, "--dataset_path", str(tmp_path))
    g, c = sage_sample_trainer.load(args)
    line = capsys.readouterr().out
    assert line.startswith("[warn] reddit unavailable (")
    assert line.rstrip().endswith("); synthetic graph")
    assert c == 16 and not list(tmp_path.iterdir())
    from gammagl_tpu.datasets import synthetic_community_graph
    want = synthetic_community_graph(5000, 16, 64, avg_degree=12, seed=0)
    assert sorted(g.keys()) == sorted(want.keys())
    for k in want.keys():
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(want[k]))


def _jax_gpu_sage_losses(d, args, n_steps):
    """The JAX script's loop (`gpu_sage_trainer.main`): its loader, its
    `pad_batch`, the cache's rows, Adam on the masked cross-entropy."""
    g = JaxGraph(**d)
    loader = jl.NodeNeighborLoader(g, num_neighbors=[8, 4],
                                   batch_size=args.batch_size, shuffle=True,
                                   seed=args.seed)
    pad = _jax_nested("gpu_sage", "main", "pad_batch")
    model = JaxSAGEModel(hidden_dim=args.hidden_dim, num_class=C,
                         drop_rate=0.0)

    @jax.jit
    def step(state, x, ei, y, mask):
        def loss_fn(p):
            logits = model.apply(p, x, ei)
            ls = optax.softmax_cross_entropy_with_integer_labels(logits, y)
            return (ls * mask).sum() / jnp.maximum(mask.sum(), 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    state, params, losses, shape = None, None, [], None
    for sub in loader:
        n_id, ei, y, mask = pad(sub)
        shape = shape or (len(n_id), ei.shape[1])
        assert (len(n_id), ei.shape[1]) == shape  # one bucket
        x = jnp.asarray(d["x"][n_id])
        if state is None:
            params = model.init(jax.random.PRNGKey(args.seed), x, ei)
            state = JaxTrainState.create(params=params,
                                         tx=optax.adam(args.lr))
        state, loss = step(state, x, ei, y, mask)
        losses.append(float(loss))
        if len(losses) == n_steps:
            return losses, params
    raise AssertionError("too few batches")


def test_gpu_sage_twin_matches_the_jax_trainer():
    """Two in-edges a node: every padded batch of 4 seeds lands in one
    bucket. The cache holds half the rows, so cold rows are gathered."""
    d = _graph(deg=2)
    args = _args(gpu_sage_trainer, "--batch_size", "4", "--n_epoch", "1")
    want, params = _jax_gpu_sage_losses(d, args, 3)
    seen = []
    out = gpu_sage_trainer.main(args, data=(Graph(**d), C),
                                params=_np_tree(params), steps=3,
                                on_batch=lambda n_id, x: seen.append(
                                    (n_id, x.clone())))
    np.testing.assert_allclose(out["losses"], want, rtol=1e-5)
    cache = out["cache"]
    assert cache.budget_rows == N // 2
    hits = sum(int((cache.slot_of[n_id] >= 0).sum()) for n_id, _ in seen)
    assert (cache.hits, cache.misses) == (hits, sum(len(n) for n, _ in seen)
                                          - hits)
    assert cache.misses > 0 and cache.hits > 0
    for n_id, x in seen:
        np.testing.assert_array_equal(x.numpy(), d["x"][n_id])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_twin_logits_match_jax(dtype):
    """Each timed request's logits against the JAX model on the same
    blocks from the same parameters: f32 at 1e-5, bf16 inputs (f32
    parameters: both promote to f32) at 3e-2 of max |logit|."""
    d = _graph()
    args = serving_demo.parser().parse_args(
        ["--device", "cpu", "--batch", "4", "--fanout1", "3", "--fanout2",
         "2", "--requests", "5", "--micro_requests", "0"])
    jmodel = JaxSampleModel(hidden_dim=64, num_class=C, num_layers=2,
                            drop_rate=0.0)
    x, eis, sizes = _sampled_batch(d, np.arange(4))
    jadjs = [(jnp.asarray(e), s) for e, s in zip(eis, sizes)]
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jadjs)
    out = serving_demo.main(args, data=(Graph(**d), C),
                            params=_np_tree(params),
                            compute_dtype=(torch.bfloat16
                                           if dtype == "bfloat16" else None))
    assert out["sessions"] == 1 and len(out["records"]) == 4
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    apply = jax.jit(lambda f, e0, e1: jmodel.apply(
        params, f, [(e0, sizes[0]), (e1, sizes[1])]))
    for n_id_p, blocks, got_sizes, logits in out["records"]:
        assert got_sizes == sizes and logits.dtype == torch.float32
        want = apply(jnp.asarray(d["x"][n_id_p]).astype(jdt), *blocks)
        assert want.dtype == jnp.float32
        _check(logits, want, 1e-5 if dtype == "float32" else 3e-2)


def test_serving_twin_micro_batcher_on_the_cpu():
    d = _graph()
    args = serving_demo.parser().parse_args(
        ["--device", "cpu", "--batch", "4", "--fanout1", "3", "--fanout2",
         "2", "--requests", "2", "--micro_requests", "12"])
    micro = serving_demo.main(args, data=(Graph(**d), C))["micro"]
    assert len(micro["outs"]) == 12 and micro["sessions"] == 2
    assert all(o.shape == (C,) and np.isfinite(o).all()
               for o in micro["outs"])
    assert sum(n for _, n in micro["batches"]) == 12
    assert all(b in serving_demo.MICRO_BUCKETS
               for b, _ in micro["batches"])


def test_neighbor_sampler_twin_runs_both_routes():
    args = neighbor_sampler.parser().parse_args(
        ["--num_nodes", "500", "--num_edges", "3000", "--batch_size", "16",
         "--iters", "1"])
    out = neighbor_sampler.main(args)
    assert sorted(out) == ["C++", "numpy"]
    assert all(ms > 0 and nodes > 16 for ms, nodes, _ in out.values())


def _write_reddit(raw, rng, n=20):
    """tests/datasets/test_raw_fixtures.py's Reddit writer."""
    os.makedirs(raw, exist_ok=True)
    np.savez(osp.join(raw, "reddit_data.npz"),
             feature=rng.random((n, 8)).astype(np.float32),
             label=rng.integers(0, 5, n),
             node_types=rng.integers(1, 4, n))
    adj = sp.csr_matrix((rng.random((n, n)) < 0.2).astype(np.float32))
    sp.save_npz(osp.join(raw, "reddit_graph.npz"), adj)


def test_reddit_from_raw_files_is_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    for root in ("port", "jax"):
        _write_reddit(str(tmp_path / root / "raw"),
                      np.random.default_rng(0))
    g = Reddit(root=str(tmp_path / "port"))[0]
    want = JaxReddit(root=str(tmp_path / "jax"))[0]
    assert g.num_nodes == want.num_nodes == 20
    assert sorted(g.keys()) == sorted(want.keys())
    for k in want.keys():
        a, b = np.asarray(g[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)
    assert osp.exists(tmp_path / "port" / "processed" / "data_torch.pkl")
    again = Reddit(root=str(tmp_path / "port"))[0]  # from the cache
    np.testing.assert_array_equal(again.edge_index, g.edge_index)


def test_sage_sample_twin_reads_staged_reddit(tmp_path, monkeypatch):
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    _write_reddit(str(tmp_path / "raw"), np.random.default_rng(1), n=60)
    args = _args(sage_sample_trainer, "--dataset_path", str(tmp_path))
    g, c = sage_sample_trainer.load(args)
    assert g.num_nodes == 60 and c == int(np.asarray(g.y).max()) + 1
