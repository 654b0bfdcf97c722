"""Sharded checkpoints, `ShardedInferenceSession`, `ShardedFeatureStore`,
the multi-process input pipeline (`loader/multihost.py`) and the twins
that use them (hetero_rgcn's dense and ``--ep`` paths, the papers twin's
``--ckpt``) against the JAX package.

* Checkpoints (`train.save_checkpoint_sharded` / `load_checkpoint_sharded`):
  a round trip bit for bit in one process and in two (each process its own
  leaves); another world size, a leaf of another shape or dtype, and a
  directory without its step file are refused.
* The papers twin: 2 epochs saving with ``--ckpt-every 2``, then a resume
  to 4: losses and parameters bitwise an uninterrupted 4-epoch run's.
* `ShardedInferenceSession` (GCN, f32) against the JAX session on as many
  virtual devices, as `tests/test_serve.py:54-70` runs it (1e-5), and
  bitwise against the port's `InferenceSession`; inputs as row blocks or
  whole; rows the group does not divide raise, as in JAX; `device_put`
  and `export`.
* `ShardedFeatureStore`: gathers bitwise against the JAX store, a -0.0
  entry and clipped indices (negative, and past the padded rows) among
  them, and the whole matrix.
* `shard_seeds` and `pad_sampled_graph` bit for bit; each process's
  `MultiHostNodeLoader` batches bitwise the JAX loader's for that host
  (one device a host; its global assembly replaced by the local arrays,
  which are that host's shard); both on the numpy sampler route.
* The hetero_rgcn twin: its typed graph is the JAX trainer's; its dense
  loss curve and its ``--ep`` curve at 1 and 2 processes against the JAX
  trainer's (rtol 1e-4; its ``--ep 2`` on 2 devices), the JAX losses read
  from its own jitted step;
  ``--ep`` other than the group's size raises; at 2 processes a sharded
  checkpoint after step 3 and a resume repeat steps 4-5 bitwise.

The two-process cases run in one module-scoped gloo job (the workers
import no JAX); the JAX references are computed once a module.
"""

import argparse
import functools
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.examples import common as tcommon
from gammagl_tpu_torch.examples import hetero_rgcn_trainer as twin
from gammagl_tpu_torch.loader import (MultiHostNodeLoader,
                                      ShardedFeatureStore, filter_graph,
                                      pad_sampled_graph, shard_seeds)
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.sampler import NeighborSampler
from gammagl_tpu_torch.serve import (InferenceSession,
                                     ShardedInferenceSession)
from gammagl_tpu_torch.train import (load_checkpoint_sharded,
                                     save_checkpoint_sharded)
from gammagl_tpu_torch.utils import load_jax_params
from tests.test_torch_parallel_strategies import finish_parts, start_parts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SN, SE, SF, SC = 64, 256, 8, 3     # the session's GCN graph
FN, FF = 37, 5                     # the feature store's matrix
MN, ME, MF = 200, 1200, 8          # the multihost graph (JAX's test's)
EPOCHS = 5


# -- cases, shared by this process and the workers (no JAX here) -------------

def _tree(rank):
    """A checkpoint tree with this process's own values."""
    g = torch.Generator().manual_seed(rank)
    return {"w": torch.randn(4, 3, generator=g),
            "opt": {"m": [torch.randn(5, generator=g).to(torch.bfloat16),
                          torch.arange(3, dtype=torch.int64) + rank],
                    "lr": 0.5 + rank, "n": np.arange(4.0) * (rank + 1)}}


def _template():
    return {"w": torch.zeros(4, 3),
            "opt": {"m": [torch.zeros(5, dtype=torch.bfloat16),
                          torch.zeros(3, dtype=torch.int64)],
                    "lr": 0.0, "n": np.zeros(4)}}


def _same_tree(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def _session_case(n=SN):
    rng = np.random.default_rng(3)
    ei = np.stack([rng.integers(0, n, SE), rng.integers(0, n, SE)])
    x = rng.normal(size=(n, SF)).astype(np.float32)
    return x, ei


def _port_gcn(params):
    return load_jax_params(GCNModel(hidden_dim=16, num_class=SC), params)


def _store_matrix():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(FN, FF)).astype(np.float32)
    x[5, 2] = -0.0
    x[FN - 1, 0] = -0.0
    return x


STORE_INDEX = np.asarray([3, -2, 5, FN - 1, FN, FN + 7, 0, 5, 19, -40])


def _mh_graph():
    rng = np.random.default_rng(0)
    ei = np.stack([rng.integers(0, MN, ME), rng.integers(0, MN, ME)])
    x = rng.normal(size=(MN, MF)).astype(np.float32)
    y = rng.integers(0, 3, MN).astype(np.int32)
    return ei.astype(np.int64), x, y


def _port_batches(process_count, rank, group_default=False):
    """Every batch of one epoch of this process's `MultiHostNodeLoader`
    (numpy sampler route) as {name: numpy}."""
    ei, x, y = _mh_graph()
    g = Graph(x=x, edge_index=ei, num_nodes=MN)
    g.y = y
    sampler = NeighborSampler(ei, MN, [5, 5], seed=0, use_ext=False)
    kw = {} if group_default else {"process_index": rank,
                                   "process_count": process_count}
    loader = MultiHostNodeLoader(g, sampler, batch_size=16, node_bucket=512,
                                 edge_bucket=2048, shuffle=True, seed=1,
                                 device="cpu", **kw)
    out = [{k: v.numpy() for k, v in b.items()} for b in loader]
    assert len(out) == len(loader)
    return out


def _ep_args(ep):
    return twin.parser().parse_args(["--device", "cpu", "--n_epoch",
                                     str(EPOCHS), "--ep", str(ep)])


def _ep_resume(ckpt):
    """At the group's size: 3 steps, a sharded checkpoint, 2 steps; then a
    fresh trainer loads it and takes the 2 steps again. Returns both
    runs' last 2 losses and weights."""
    size = torch.distributed.get_world_size() if \
        torch.distributed.is_initialized() else 1
    args = _ep_args(size)
    data = twin.typed_graph()
    a = twin.ExpertRGCN(args, data)
    for _ in range(3):
        a.step()
    save_checkpoint_sharded(ckpt, tcommon.checkpoint_tree(a.params, a.opt),
                            step=3)
    la = [a.step() for _ in range(2)]
    b = twin.ExpertRGCN(args, data)
    tree, step = load_checkpoint_sharded(
        ckpt, tcommon.checkpoint_tree(b.params, b.opt))
    assert step == 3
    tcommon.restore_checkpoint_tree(b.params, b.opt, tree)
    lb = [b.step() for _ in range(2)]
    return {"resume:a": np.asarray(la), "resume:b": np.asarray(lb),
            **{f"resume:{k}:a": a.params[k].detach().numpy()
               for k in a.params},
            **{f"resume:{k}:b": b.params[k].detach().numpy()
               for k in b.params}}


WORKER = r"""
import datetime, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
inp, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
d = np.load(inp)
P_ = int(d["P"])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=P_,
                        timeout=datetime.timedelta(seconds=90))
sys.path.insert(0, ".")
import tests.test_torch_parallel_serving as T
from gammagl_tpu_torch import loader, serve, train
from gammagl_tpu_torch.examples import hetero_rgcn_trainer as twin
res = {}
# checkpoints: each process's own leaves
ckpt = inp[:-4] + "_ckpt"
train.save_checkpoint_sharded(ckpt, T._tree(rank), step=7)
got, step = train.load_checkpoint_sharded(ckpt, T._template())
res["ckpt:same"] = np.asarray(T._same_tree(got, T._tree(rank)))
res["ckpt:step"] = np.asarray(step)
# the session: x as this process's rows, then whole; out its rows
params = {k[2:]: d[k] for k in d.files if k.startswith("p:")}
tree = {}
for key, v in params.items():
    node = tree
    *path, leaf = key.split("/")
    for part in path:
        node = node.setdefault(part, {})
    node[leaf] = v
x, ei = T._session_case()
b = x.shape[0] // P_
sess = serve.ShardedInferenceSession(T._port_gcn(tree), (x, ei),
                                     in_specs=("dp", None), out_specs="dp",
                                     device="cpu")
blk = sess(x[rank * b:(rank + 1) * b], ei)
whole = serve.InferenceSession(T._port_gcn(tree), (x, ei), device="cpu")(
    x, ei)
res["sess:out"] = blk.numpy()
res["sess:bitwise"] = np.asarray(torch.equal(blk, whole[rank * b:(rank + 1)
                                                        * b]))
res["sess:whole_in"] = np.asarray(torch.equal(sess(x, ei), blk))
res["sess:put"] = np.asarray(torch.equal(sess.device_put(x, ei)[0],
                                         torch.from_numpy(x[rank * b:
                                                            (rank + 1) * b])))
full = serve.ShardedInferenceSession(T._port_gcn(tree), (x, ei),
                                     in_specs=(("dp", None), None),
                                     device="cpu")
res["sess:full"] = full(x[rank * b:(rank + 1) * b], ei).numpy()
x63, ei63 = T._session_case(63)
try:
    serve.ShardedInferenceSession(T._port_gcn(tree), (x63, ei63),
                                  in_specs=("dp", None), device="cpu")
    res["sess:odd_raises"] = np.asarray(False)
except ValueError:
    res["sess:odd_raises"] = np.asarray(True)
# the feature store
fs = loader.ShardedFeatureStore(device="cpu")
fs.put_tensor(T._store_matrix(), group_name="paper", attr_name="x")
res["store:rows"] = fs.get_tensor("paper", "x", T.STORE_INDEX).numpy()
res["store:all"] = fs["paper", "x"].numpy()
res["store:block"] = fs._store[("paper", "x")][0].numpy()
# the loader, with the group's rank and size
for i, batch in enumerate(T._port_batches(P_, rank, group_default=True)):
    for k, v in batch.items():
        res[f"mh:{i}:{k}"] = v
# the hetero_rgcn twin
res["ep:losses"] = np.asarray(twin.main(T._ep_args(P_))["losses"])
res.update(T._ep_resume(inp[:-4] + "_ep_ckpt"))
dist.barrier()
dist.destroy_process_group()
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "gammagl_tpu" or m.startswith("gammagl_tpu.")]
assert not bad, bad
np.savez(inp[:-4] + f"_out{rank}.npz", **res)
"""


# -- the JAX references -------------------------------------------------------

def _mesh(P_, axis="dp"):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:P_]), (axis,))


@functools.lru_cache(maxsize=None)
def _jax_gcn():
    import jax
    import jax.numpy as jnp
    from gammagl_tpu.models import GCNModel as JaxGCNModel
    x, ei = _session_case()
    model = JaxGCNModel(hidden_dim=16, num_class=SC)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(ei))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@functools.lru_cache(maxsize=None)
def _jax_session(P_):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from gammagl_tpu.serve import ShardedInferenceSession as JaxSession
    model, params = _jax_gcn()
    x, ei = _session_case()
    sess = JaxSession(model.apply, params, (jnp.asarray(x), jnp.asarray(ei)),
                      _mesh(P_), in_specs=(P("dp"), P()), out_specs=P("dp"))
    return np.asarray(sess(jnp.asarray(x), jnp.asarray(ei)))


@functools.lru_cache(maxsize=None)
def _jax_store(P_):
    from gammagl_tpu.loader import ShardedFeatureStore as JaxStore
    st = JaxStore(_mesh(P_))
    st.put_tensor(_store_matrix(), group_name="paper", attr_name="x")
    return (np.asarray(st.get_tensor("paper", "x", STORE_INDEX)),
            np.asarray(st.get_tensor("paper", "x")))


def _jax_batches(process_count, rank, monkeypatch):
    """The JAX loader's batches for host ``rank`` of ``process_count``,
    one device a host: its global assembly replaced by the host's local
    arrays (its shard of the global batch)."""
    from gammagl_tpu.data import Graph as JaxGraph
    from gammagl_tpu.loader import multihost as jmh
    from gammagl_tpu.sampler import NeighborSampler as JaxSampler
    monkeypatch.setattr(jmh, "make_global_batch",
                        lambda mesh, tree, spec=None: tree)
    ei, x, y = _mh_graph()
    g = JaxGraph(x=x, edge_index=ei, num_nodes=MN)
    g.y = y
    sampler = JaxSampler(ei, MN, [5, 5], seed=0, use_ext=False)
    mesh = argparse.Namespace(shape={"dp": process_count})
    loader = jmh.MultiHostNodeLoader(
        g, sampler, mesh, batch_size=16, node_bucket=512, edge_bucket=2048,
        shuffle=True, seed=1, process_index=rank,
        process_count=process_count)
    out = list(loader)
    assert len(out) == len(loader)
    return out


@functools.lru_cache(maxsize=None)
def _jax_twin(ep):
    """The JAX hetero_rgcn trainer's losses, read from its own jitted step
    by wrapping the ``jax.jit`` its module calls (the step returns the
    loss last), and the parameters it starts from (dense path: caught at
    ``TrainState.create``). Its model's init and its expert SpMM are
    wrapped in ``jax.jit``, so the trainer's eager init and accuracy
    forwards compile once, not op by op."""
    import jax
    sys.path.insert(0, REPO)
    import gammagl_tpu.parallel as jpar
    from examples import common as jcommon
    from examples.hetero_rgcn import hetero_rgcn_trainer as jtwin
    losses, start = [], []
    state_cls = jtwin.TrainState

    class Recorder:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn):
            jitted = jax.jit(fn)

            def call(*a):
                out = jitted(*a)
                if isinstance(out, tuple):
                    losses.append(float(out[-1]))
                return out
            return call

    class State:
        @staticmethod
        def create(params, tx):
            start.append(jax.tree_util.tree_map(np.asarray, params))
            return state_cls.create(params=params, tx=tx)

    model_cls = jtwin.RGCNModel

    class JitInit(model_cls):
        def init(self, *a, **kw):
            return jax.jit(functools.partial(model_cls.init, self))(*a, **kw)

    make = jpar.make_relation_expert_spmm
    p = jcommon.base_parser(hidden_dim=16, n_epoch=50, lr=0.005)
    p.add_argument("--ep", type=int, default=0)
    args = p.parse_args(["--n_epoch", str(EPOCHS), "--ep", str(ep)])
    mp = pytest.MonkeyPatch()
    mp.setattr(jtwin, "jax", Recorder())
    mp.setattr(jtwin, "TrainState", State)
    mp.setattr(jtwin, "RGCNModel", JitInit)
    mp.setattr(jpar, "make_relation_expert_spmm",
               lambda *a, **kw: jax.jit(make(*a, **kw)))
    try:
        jtwin.main(args)
    finally:
        mp.undo()
    return losses, (start[0] if start else None)


def _check_store(rows, whole, P_):
    """Bitwise the stored rows (the matrix padded to a multiple of P_ with
    zeros, indices clipped as numpy's ``take(mode="clip")``), -0.0
    included; equal in value to the JAX store's. (JAX's gather across
    devices sums masked shares, so at 2 devices its -0.0 comes back
    +0.0: ROADMAP C59.)"""
    x = _store_matrix()
    padded = np.concatenate([x, np.zeros(((-FN) % P_, FF), np.float32)])
    want = np.take(padded, STORE_INDEX, axis=0, mode="clip")
    np.testing.assert_array_equal(rows.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(whole.view(np.uint32), x.view(np.uint32))
    assert np.signbit(rows[2, 2]) and np.signbit(rows[3, 0])
    jrows, jwhole = _jax_store(P_)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(whole, jwhole)


# -- one process ---------------------------------------------------------------

def test_checkpoint_round_trip_in_one_process(tmp_path):
    d = tmp_path / "ckpt"
    save_checkpoint_sharded(d, _tree(0), step=11)
    got, step = load_checkpoint_sharded(d, _template())
    assert step == 11 and _same_tree(got, _tree(0))
    assert isinstance(got["opt"]["n"], np.ndarray)
    bad = _template()
    bad["w"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="leaf w"):
        load_checkpoint_sharded(d, bad)
    bad = _template()
    bad["opt"]["m"][0] = torch.zeros(5)
    with pytest.raises(ValueError, match="bfloat16"):
        load_checkpoint_sharded(d, bad)
    bad = _template()
    del bad["opt"]["lr"]
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint_sharded(d, bad)
    save_checkpoint_sharded(d, _tree(0))  # overwrite: step None is 0
    assert load_checkpoint_sharded(d, _template())[1] == 0
    os.remove(d / "step.json")
    with pytest.raises(FileNotFoundError, match="no complete"):
        load_checkpoint_sharded(d, _template())


def test_papers_twin_resumes_bitwise(tmp_path):
    from gammagl_tpu_torch.examples import papers100m_trainer as papers
    base = ["--device", "cpu", "--scale", "0.00002", "--f32", "--hidden",
            "32"]
    ckpt = str(tmp_path / "papers")

    def run(*flags):
        args = papers.parser().parse_args(base + list(flags))
        return papers.train(args, prep)

    prep = papers.prepare(papers.parser().parse_args(base))
    full = run("--epochs", "4")
    first = run("--epochs", "2", "--ckpt", ckpt, "--ckpt-every", "2")
    assert os.path.exists(os.path.join(ckpt, "step.json"))
    rest = run("--epochs", "4", "--ckpt", ckpt, "--ckpt-every", "2")
    assert len(first["losses"]) == len(rest["losses"]) == 2
    assert first["losses"] + rest["losses"] == full["losses"]
    for k, v in full["params"].items():
        assert torch.equal(rest["params"][k], v), k


def test_sharded_session_in_one_process_matches_jax():
    model, params = _jax_gcn()
    x, ei = _session_case()
    sess = ShardedInferenceSession(_port_gcn(params), (x, ei),
                                   in_specs=("dp", None), out_specs="dp",
                                   device="cpu")
    got = sess(x, ei)
    np.testing.assert_allclose(got.numpy(), _jax_session(1), rtol=1e-5,
                               atol=1e-5)
    plain = InferenceSession(_port_gcn(params), (x, ei), device="cpu")
    assert torch.equal(got, plain(x, ei))
    exported = sess.export().module()
    assert torch.equal(exported(torch.from_numpy(x), torch.from_numpy(ei)),
                       got)
    with pytest.raises(NotImplementedError, match="row blocks"):
        ShardedInferenceSession(_port_gcn(params), (x, ei),
                                in_specs=((None, "dp"), None), device="cpu")


def test_sharded_feature_store_in_one_process_matches_jax():
    st = ShardedFeatureStore(device="cpu")
    st.put_tensor(_store_matrix(), group_name="paper", attr_name="x")
    rows, whole = _jax_store(1)
    got = st.get_tensor("paper", "x", torch.from_numpy(STORE_INDEX))
    _check_store(got.numpy(), st["paper", "x"].numpy(), 1)
    assert st.get_all_tensor_attrs()[0].attr_name == "x"
    assert st.remove_tensor("paper", "x")


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("count", [1, 3, 4])
def test_shard_seeds_are_jax_bit_for_bit(count, drop):
    from gammagl_tpu.loader import shard_seeds as jax_shard_seeds
    seeds = np.random.default_rng(2).permutation(103)
    for i in range(count):
        np.testing.assert_array_equal(
            shard_seeds(seeds, i, count, drop_remainder=drop),
            jax_shard_seeds(seeds, i, count, drop_remainder=drop))
    np.testing.assert_array_equal(shard_seeds(seeds), seeds)  # no group
    with pytest.raises(ValueError, match="cannot be split"):
        shard_seeds(seeds[:2], 0, 3)


def test_pad_sampled_graph_is_jax_bit_for_bit():
    from gammagl_tpu.loader import pad_sampled_graph as jax_pad
    ei, x, y = _mh_graph()
    g = Graph(x=x, edge_index=ei, num_nodes=MN)
    g.y = y
    out = NeighborSampler(ei, MN, [5, 5], seed=0,
                          use_ext=False).sample_from_nodes(np.arange(8))
    sub = filter_graph(g, out)
    got, want = pad_sampled_graph(sub, 256, 1024, 8), jax_pad(
        sub, 256, 1024, 8)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="bucket too small"):
        pad_sampled_graph(sub, 4, 1024, 8)


def _check_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_multihost_loader_in_one_process_matches_jax(monkeypatch):
    _check_batches(_port_batches(1, 0), _jax_batches(1, 0, monkeypatch))


def test_hetero_rgcn_typed_graph_is_the_jax_trainers():
    sys.path.insert(0, REPO)
    from examples.hetero_rgcn import hetero_rgcn_trainer as jtwin
    x, ei, et, y, n_m, n_rel, train, test = jtwin.typed_graph(None)
    d = twin.typed_graph()
    for name, want in (("x", x), ("edge_index", ei), ("edge_type", et),
                       ("y", y), ("train_mask", train), ("test_mask", test)):
        np.testing.assert_array_equal(d[name], np.asarray(want), name)
    assert (d["n_m"], d["num_relations"]) == (n_m, n_rel)


def test_hetero_rgcn_dense_twin_matches_the_jax_trainer():
    want, params = _jax_twin(0)
    got = twin.main(_ep_args(0), params=params)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


def test_hetero_rgcn_ep_twin_in_one_process_matches_the_jax_trainer():
    got = twin.main(_ep_args(1))
    # JAX's expert tier on 2 devices computes the function of 1 device
    np.testing.assert_allclose(got["losses"], _jax_twin(2)[0], rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    with pytest.raises(ValueError, match="--ep 2"):
        twin.main(_ep_args(2))


# -- two processes -------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """The 2-process job, started with the module; the JAX GCN's
    parameters go to it as flat arrays."""
    _, params = _jax_gcn()
    tmp = tmp_path_factory.mktemp("serving2")
    return {"tmp": tmp, "handle": start_parts(
        tmp, 2, WORKER, **{f"p:{k}": v for k, v in _flat(params).items()})}


@pytest.fixture(scope="module")
def job(launched):
    if "parts" not in launched:
        launched["parts"] = finish_parts(launched["handle"])
    return launched["tmp"], launched["parts"]


def test_checkpoint_round_trip_across_processes(job):
    tmp, parts = job
    for part in parts:
        assert part["ckpt:same"] and part["ckpt:step"] == 7
    names = sorted(os.listdir(tmp / "in_ckpt"))
    assert names == ["shard00000-of-00002.pt", "shard00001-of-00002.pt",
                     "step.json"]
    with pytest.raises(ValueError, match="written by 2 process"):
        load_checkpoint_sharded(tmp / "in_ckpt", _template())
    copy = tmp / "incomplete"
    shutil.copytree(tmp / "in_ckpt", copy)
    os.remove(copy / "step.json")
    with pytest.raises(FileNotFoundError):
        load_checkpoint_sharded(copy, _template())


def test_sharded_session_across_processes_matches_jax(job):
    _, parts = job
    want = _jax_session(2)
    got = np.concatenate([p["sess:out"] for p in parts])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for p in parts:
        assert p["sess:bitwise"] and p["sess:whole_in"] and p["sess:put"]
        np.testing.assert_array_equal(p["sess:full"], got)
        assert p["sess:odd_raises"]
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from gammagl_tpu.serve import ShardedInferenceSession as JaxSession
    model, params = _jax_gcn()
    x, ei = _session_case(63)
    with pytest.raises(ValueError, match="divisible"):  # JAX's rule too
        JaxSession(model.apply, params, (jnp.asarray(x), jnp.asarray(ei)),
                   _mesh(2), in_specs=(P("dp"), P()), out_specs=P("dp"))


def test_sharded_feature_store_across_processes_matches_jax(job):
    _, parts = job
    x = _store_matrix()
    for r, p in enumerate(parts):
        _check_store(p["store:rows"], p["store:all"], 2)
        per = -(-FN // 2)
        np.testing.assert_array_equal(
            p["store:block"], np.concatenate([x, np.zeros((1, FF),
                                                          np.float32)])[
                r * per:(r + 1) * per])


def test_multihost_loader_across_processes_matches_jax(job, monkeypatch):
    _, parts = job
    seeds = []
    for r, p in enumerate(parts):
        n = len({k.split(":")[1] for k in p if k.startswith("mh:")})
        got = [{k.split(":")[2]: p[k] for k in p
                if k.startswith(f"mh:{i}:")} for i in range(n)]
        _check_batches(got, _jax_batches(2, r, monkeypatch))
        seeds.append(np.concatenate([b["n_id"][0][:16] for b in got]))
    assert not np.intersect1d(seeds[0], seeds[1]).size


def test_hetero_rgcn_ep_twin_across_processes_matches_the_jax_trainer(job):
    _, parts = job
    want = _jax_twin(2)[0]
    for p in parts:
        np.testing.assert_allclose(p["ep:losses"], want, rtol=1e-4)
        np.testing.assert_array_equal(p["ep:losses"], parts[0]["ep:losses"])
        assert np.array_equal(p["resume:a"], p["resume:b"])
        for k in ("w1", "w2"):
            np.testing.assert_array_equal(p[f"resume:{k}:a"],
                                          p[f"resume:{k}:b"])
