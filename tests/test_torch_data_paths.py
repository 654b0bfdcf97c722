"""The twins' loaders against the JAX trainers', on the CPU, with
``GGL_TPU_OFFLINE=1`` (no test touches the network or waits on DNS):
`examples.common.load_node_dataset`'s chain (Planetoid's raw files, the
real-structure step, the synthetic fallback and its warning line),
ROADMAP C15 (the fallback graph does not follow ``--seed``), the papers
twin's `load_ogb_root` / `load_real` on npy files opened read-only, and
a GCN twin trained from Planetoid files against the JAX trainer's loss
curve. Loss curves at rtol 1e-4, as the twin tests of
`test_torch_train.py`.
"""

import argparse
import os
import os.path as osp
import sys
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))
import examples.common as jcommon  # noqa: E402
from examples.papers100m import papers100m_trainer as jpapers  # noqa: E402
from gammagl_tpu.models import GATModel as JaxGATModel  # noqa: E402
from gammagl_tpu.models import GATV2Model as JaxGATV2Model  # noqa: E402
from gammagl_tpu.models import GCNModel as JaxGCNModel  # noqa: E402
from gammagl_tpu.train import TrainState as JaxTrainState  # noqa: E402
from gammagl_tpu.train import semi_supervised_loss as jax_loss  # noqa: E402

from gammagl_tpu_torch.data import Graph  # noqa: E402
from gammagl_tpu_torch.examples import common  # noqa: E402
from gammagl_tpu_torch.examples import (  # noqa: E402
    fusedgat_trainer, gat_trainer, gatv2_trainer, gcn_trainer)
from gammagl_tpu_torch.examples import (  # noqa: E402
    papers100m_trainer as papers)
from gammagl_tpu_torch.parallel import shard_nodes  # noqa: E402

from test_torch_io_datasets import write_planetoid  # noqa: E402


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    """Offline, both loaders' caches empty, the working directory a
    temporary one (the real-structure cache is written under it), and no
    reference checkout or forced-shape switch from the environment."""
    monkeypatch.setenv("GGL_TPU_OFFLINE", "1")
    for var in ("GGL_SYNTHETIC", "GGL_REAL_SHAPES", "GGL_REFERENCE_ROOT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(common, "_DS_CACHE", {})
    monkeypatch.setattr(jcommon, "_DS_CACHE", {})
    monkeypatch.setattr(jcommon, "_STRUCT_ADJ", {})  # no reference checkout
    monkeypatch.chdir(tmp_path)


def _same_graph(got, want):
    assert isinstance(got, Graph)
    assert got.num_nodes == want.num_nodes
    for k, v in want.items():
        if k == "data_kind":
            assert got[k] == v
            continue
        a, b = np.asarray(got[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert list(got.keys()) == list(want.keys())


# -- load_node_dataset --------------------------------------------------------

@pytest.mark.parametrize("name", ["cora", "citeseer", "pubmed"])
def test_planetoid_files_load_as_in_jax(tmp_path, name):
    path = str(tmp_path / "ds")
    write_planetoid(osp.join(path, name, "raw"), name, 9, 14, 6, 3, seed=2,
                    gaps=2 if name == "citeseer" else 0)
    got, c = common.load_node_dataset(name, path)
    want, jc = jcommon.load_node_dataset(name, path)
    assert c == jc == 3
    _same_graph(got, want)
    assert common.load_node_dataset(name, path)[0] is got  # cached
    args = argparse.Namespace(dataset=name, dataset_path=path)
    assert common.probe_num_classes(args) == jcommon.probe_num_classes(args)
    assert sorted(os.listdir(osp.join(path, name, "processed"))) == [
        "data.pkl", "data_torch.pkl"]


@pytest.mark.parametrize("name,shapes", [("cora", False), ("pubmed", False),
                                         ("cora", True), ("arxiv", False)])
def test_fallback_chain_matches_jax(tmp_path, capsys, monkeypatch, name,
                                    shapes):
    if shapes:
        monkeypatch.setenv("GGL_REAL_SHAPES", "1")
    path = str(tmp_path / "nothing")
    got, c = common.load_node_dataset(name, path)
    port_out = capsys.readouterr().out
    want, jc = jcommon.load_node_dataset(name, path)
    assert port_out == capsys.readouterr().out
    if name != "arxiv":
        assert port_out == (f"[warn] {name} unavailable (no network (fast "
                            "probe) and no raw files); trying "
                            "real-structure fallback\n")
    assert c == jc
    _same_graph(got, want)
    assert got.num_nodes == (2708 if shapes else 1000)


def test_real_structure_step_matches_jax(tmp_path, monkeypatch):
    """A reference checkout (``GGL_REFERENCE_ROOT``) with cora's
    adjacency: both packages derive the same node data from it, and
    ``GGL_SYNTHETIC`` skips the step in both."""
    pytest.importorskip("sklearn")
    import scipy.sparse as sp
    ref = tmp_path / "reference"
    adj_path = ref / common._STRUCT_ADJ["cora"]
    os.makedirs(adj_path.parent)
    rng = np.random.default_rng(0)
    n = 2708
    a = sp.coo_matrix((np.ones(9000), (rng.integers(0, n, 9000),
                                       rng.integers(0, n, 9000))), (n, n))
    a = (a + a.T + sp.eye(n)).tocsr()
    np.savez(adj_path, indptr=a.indptr, indices=a.indices, shape=a.shape)
    monkeypatch.setenv("GGL_REFERENCE_ROOT", str(ref))
    monkeypatch.setattr(jcommon, "_STRUCT_ADJ", {"cora": str(adj_path)})
    got, c = common.load_node_dataset("cora", str(tmp_path / "none"))
    os.remove(osp.join("data", "cora", "struct_cache_f128.npz"))
    want, jc = jcommon.load_node_dataset("cora", str(tmp_path / "none"))
    assert c == jc == 7 and got.data_kind == "real-structure"
    _same_graph(got, want)
    monkeypatch.setenv("GGL_SYNTHETIC", "1")
    monkeypatch.setattr(common, "_DS_CACHE", {})
    assert common.load_node_dataset("cora", "none")[0].num_nodes == 1000
    assert common.load_sparse_npz(str(adj_path))[1] == n


# -- C15 ----------------------------------------------------------------------

def _jax_losses(make_model, graph, args, steps):
    """The JAX trainers' step (`examples/common.py`
    `run_simple_node_trainer`: init from PRNGKey(seed), Adam with decayed
    weights, the masked cross-entropy), dropout off, on ``graph``."""
    d = jcommon.device_graph(graph)
    model = make_model(int(np.asarray(graph.y).max()) + 1)
    key = jax.random.PRNGKey(args.seed)
    params = jax.jit(lambda k: model.init({"params": k, "dropout": k},
                                          d["x"], d["edge_index"]))(key)
    tx = optax.chain(optax.add_decayed_weights(args.l2_coef),
                     optax.adam(args.lr))
    state = JaxTrainState.create(params=params, tx=tx)

    @jax.jit
    def step(state):
        loss, grads = jax.value_and_grad(lambda p: jax_loss(model.apply(
            p, d["x"], d["edge_index"], train=True, rngs={"dropout": key}),
            d["y"], d["train_mask"]))(state.params)
        return state.apply_gradients(grads), loss

    out = []
    for _ in range(steps):
        state, loss = step(state)
        out.append(float(loss))
    return out, jax.tree_util.tree_map(np.asarray, params)


TWINS = {"gat": (gat_trainer, lambda c: JaxGATModel(
             hidden_dim=4, num_class=c, heads=8, drop_rate=0.0)),
         "gatv2": (gatv2_trainer, lambda c: JaxGATV2Model(
             hidden_dim=4, num_class=c, heads=8, drop_rate=0.0)),
         "gcn": (gcn_trainer, lambda c: JaxGCNModel(
             hidden_dim=4, num_class=c, drop_rate=0.0))}


def _twin_args(module, path, *argv):
    return module.parser().parse_args(
        ["--device", "cpu", "--hidden_dim", "4", "--drop_rate", "0.0",
         "--dataset_path", path, *argv])


@pytest.mark.parametrize("name", sorted(TWINS))
def test_c15_seed_does_not_move_the_fallback_graph(tmp_path, name):
    """ROADMAP C15: with ``--seed 1`` the JAX trainers train on the
    fallback graph drawn at seed 0; the twin loads the same graph, bit
    for bit, and its loss curve is the JAX trainer's at that seed."""
    module, jax_model = TWINS[name]
    path = str(tmp_path / "empty")
    graph, _ = common.load_node_dataset("cora", path)
    jgraph, _ = jcommon.load_node_dataset("cora", path)
    _same_graph(graph, jgraph)
    args = _twin_args(module, path, "--seed", "1", "--n_epoch", "4")
    want, params = _jax_losses(jax_model, jgraph, args, 4)
    got = module.main(args, params=params)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    seeded = common.node_arrays(jgraph)
    drawn = common.synthetic_community_graph(seed=1)
    assert not np.array_equal(seeded["x"], drawn["x"])


def test_c15_fusedgat_trains_on_the_loaders_graph(tmp_path):
    path = str(tmp_path / "empty")
    args = fusedgat_trainer.parser().parse_args(
        ["--device", "cpu", "--seed", "1", "--n_epoch", "2",
         "--hidden_dim", "4", "--heads", "2", "--dataset_path", path])
    got = fusedgat_trainer.main(args)
    graph = jcommon.load_node_dataset("cora", path)[0]
    want = fusedgat_trainer.main(args, data=common.node_arrays(graph))
    assert got["losses"] == want["losses"]


def test_gcn_twin_from_planetoid_files_matches_the_jax_trainer(tmp_path):
    path = str(tmp_path / "ds")
    write_planetoid(osp.join(path, "cora", "raw"), "cora", 30, 40, 16, 4,
                    seed=5, n_edges=4)
    args = _twin_args(gcn_trainer, path, "--n_epoch", "5")
    jgraph, _ = jcommon.load_node_dataset("cora", path)
    want, params = _jax_losses(TWINS["gcn"][1], jgraph, args, 5)
    got = gcn_trainer.main(args, params=params)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    # a Graph handed in trains as its arrays do
    again = gcn_trainer.main(args, data=common.load_node_dataset(
        "cora", path)[0], params=params)
    assert again["losses"] == got["losses"]


# -- the papers twin's loaders ------------------------------------------------

@pytest.fixture
def staged(tmp_path):
    """The papers twin's synthetic shard at a tiny scale, staged in OGB's
    npy layout and as loose npy files; labels float with a NaN row."""
    ei, x, y, train, val, _ = papers.synthetic_papers(0.00002, seed=3)
    base = tmp_path / "ogb" / "ogbn_papers100M"
    raw, split = base / "raw", base / "split" / "time"
    os.makedirs(raw)
    os.makedirs(split)
    unlabeled = int(np.nonzero(~train)[0][0])  # not a training row
    lbl = y.astype(np.float64)
    lbl[unlabeled] = np.nan
    np.save(raw / "node_feat.npy", x)
    np.save(raw / "edge_index.npy", ei)
    np.save(raw / "node_label.npy", lbl)
    np.save(split / "train.npy", np.nonzero(train)[0])
    np.save(split / "valid.npy", np.nonzero(val)[0])
    loose = argparse.Namespace(
        features=str(raw / "node_feat.npy"),
        edges_file=str(raw / "edge_index.npy"),
        labels=str(raw / "node_label.npy"),
        train_idx=str(split / "train.npy"), val_idx=str(split / "valid.npy"))
    y = y.copy()
    y[unlabeled] = -1
    return str(tmp_path / "ogb"), loose, (ei, x, y, train, val)


def test_papers_loaders_match_jax(staged):
    root, loose, (ei, x, y, train, val) = staged
    for got, want in ((papers.load_ogb_root(root),
                       jpapers.load_ogb_root(root)),
                      (papers.load_real(loose), jpapers.load_real(loose))):
        assert len(got) == len(want) == 6
        assert got[5] == want[5]
        for a, b in zip(got[:5], want[:5]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[:5], (ei, x, y, train, val)):
            np.testing.assert_array_equal(a, b)
        assert isinstance(got[1], np.memmap) and not got[1].flags.writeable
    loose.val_idx = None
    assert not papers.load_real(loose)[4].any()


def test_papers_twin_trains_from_staged_files_as_from_arrays(staged):
    """``--data-root`` takes precedence over ``--features``; the features
    reach the device without a warning about read-only memory; the
    losses are bitwise those of the same arrays handed in."""
    root, loose, arrays = staged
    argv = ["--device", "cpu", "--epochs", "2", "--hidden", "16",
            "--layers", "2"]
    args = papers.parser().parse_args(argv + ["--data-root", root,
                                              "--features", "/nowhere.npy"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        prep = papers.prepare(args)
        out = papers.train(args, prep)
    ei, x, y, train, val = arrays
    plain = papers.main(papers.parser().parse_args(argv),
                        data=(ei, x, y, train, val, prep["c"]))
    assert out["losses"] == plain["losses"] and out["scale"] is None
    torch.testing.assert_close(
        prep["xs"], shard_nodes(x, prep["part"], device="cpu",
                                dtype=torch.bfloat16), rtol=0, atol=0)
    args = papers.parser().parse_args(argv + ["--features", loose.features,
                                              "--edges-file",
                                              loose.edges_file, "--labels",
                                              loose.labels, "--train-idx",
                                              loose.train_idx])
    assert papers.main(args)["losses"] == out["losses"]


@pytest.mark.parametrize("balance", [True, False])
def test_shard_nodes_reads_only_its_block(balance):
    from gammagl_tpu_torch.parallel import (build_halo_partition,
                                            pad_nodes)
    rng = np.random.default_rng(4)
    n = 50
    ei = rng.integers(0, n, (2, 300))
    part = build_halo_partition(ei, n, 3, np.ones(300, np.float32),
                                balance=balance)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x.flags.writeable = False
    want = pad_nodes(x, part, fill=-1)
    rows = part.rows_per
    for rank in range(3):
        got = shard_nodes(x, part, rank=rank, device="cpu", fill=-1)
        np.testing.assert_array_equal(
            got.numpy(), want[rank * rows:(rank + 1) * rows])


@pytest.mark.parametrize("chunked", [False, True])
def test_loss_reads_unlabeled_rows_as_jax_does(monkeypatch, chunked):
    """OGB's unlabeled rows carry -1 (masked out): the recipes' loss, the
    whole-array one and the chunked one, is JAX's on them, where
    `F.cross_entropy` alone refuses the label."""
    import optax
    from gammagl_tpu_torch.parallel import full_graph
    if chunked:
        monkeypatch.setattr(full_graph, "CHUNK_ROWS", 10)
    rows = 60
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(rows, 5)).astype(np.float32)
    y = rng.integers(-1, 5, rows)
    mask = (y >= 0) & (rng.random(rows) < 0.7)
    ls = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits), jnp.asarray(y))
    want = float((ls * mask).sum() / max(mask.sum(), 1))
    t = torch.from_numpy(logits).requires_grad_()
    got = full_graph._loss(t, torch.from_numpy(y), torch.from_numpy(mask),
                           1, None)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    got.backward()
    assert torch.isfinite(t.grad).all()
    assert not t.grad[torch.from_numpy(~mask)].any()
