"""What the trainer twins share: the dataset loader, the flags and the
full-batch node-classification loops (counterpart of `examples/common.py`'s
`load_node_dataset`, `base_parser`, `run_simple_node_trainer`,
`synthetic_hetero` and `run_hetero_trainer`).

The homogeneous twins load their graph through `load_node_dataset`, the
JAX trainers' chain: Planetoid's raw files under
``<dataset_path>/<name>/raw`` (fetched only when missing and the network
answers; ``GGL_TPU_OFFLINE=1`` skips that), then the real-structure
fallback, then `synthetic_community_graph` (1000 nodes, 7 classes, 128
features, seed 0 whatever ``--seed`` is), or take numpy arrays handed in.
For typed graphs the loops take a `HeteroGraph` handed in, or the
twin's dataset (`load_imdb`: IMDB's files under ``--dataset_path``),
or, when that fails, `synthetic_hetero` (the JAX package's
movie/director graph, the same stream), as the JAX loops fall back.
Datasets are read from staged files only (`staged_dataset`): a twin
never fetches, so a machine without the files takes the fallback;
`run_edge_type_trainer` trains a model of one node set whose edges carry
a type (RGCN, SimpleHGN) on arrays handed in. The homogeneous loop hands
the model a `CSRPlan` when its forward takes one, on the card and on the
CPU alike: on the card the plan path runs the hand-written kernels, on the
CPU their plain versions. The typed loops hand the model plans
(`HeteroGraph.csr_plans()`, or the edges' `CSRPlan`) on the card, where
the JAX loops hand theirs to a TPU; on the CPU they take the COO route.
(The JAX loops plan only on a TPU, where their kernels are not
interpreted.)
"""

import argparse
import copy
import inspect
import os
import os.path as osp
import time

import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.data import Graph, HeteroGraph
from gammagl_tpu_torch.data.download import network_available
from gammagl_tpu_torch.datasets import IMDB, Planetoid
from gammagl_tpu_torch.datasets import (
    synthetic_community_graph as _synthetic_graph)
from gammagl_tpu_torch.ops.cuda import build_csr_plan
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import (add_self_loops, load_jax_params,
                                     resolve_device)

__all__ = ["synthetic_community_graph", "load_node_dataset",
           "probe_num_classes", "load_sparse_npz", "structure_node_data",
           "node_arrays", "node_data", "base_parser", "loss_and_grad",
           "train_step", "run_simple_node_trainer", "synthetic_hetero",
           "hetero_tensors", "predict", "staged_dataset", "load_imdb",
           "run_hetero_trainer", "run_edge_type_trainer", "linear_probe",
           "device_graph", "run_two_view_ssl", "run_corruption_ssl",
           "binary_auc"]


def node_arrays(graph):
    """The loop's fields of a node-classification `Graph` as a dict of
    numpy arrays: x, edge_index, y and the train / val / test masks."""
    out = {k: np.asarray(graph[k]) for k in ("x", "edge_index", "y")}
    n = out["x"].shape[0]
    for k in ("train_mask", "val_mask", "test_mask"):
        out[k] = np.asarray(graph[k]).reshape(n, -1)[:, 0]
    return out


def synthetic_community_graph(num_nodes=1000, num_classes=7, feat_dim=128,
                              avg_degree=8, p_intra=0.9, seed=0,
                              feature_signal=0.3):
    """`datasets.synthetic_community_graph` (the JAX package's
    stochastic-block-model graph, the same numpy stream) at the trainers'
    fallback size, as a dict of numpy arrays (`node_arrays`)."""
    return node_arrays(_synthetic_graph(num_nodes, num_classes, feat_dim,
                                        avg_degree, p_intra, seed,
                                        feature_signal))


_DS_CACHE = {}


def load_node_dataset(name, path="data"):
    """(Graph, num_classes) of ``name``, by the JAX trainers' chain:
    Planetoid (cora, citeseer, pubmed) from ``<path>/<name>/raw``, or the
    real-structure graph, or the synthetic community graph (1000 nodes,
    7 classes, 128 features, seed 0). Cached per (name, path), so a
    trainer can size its head before the loop reads the graph."""
    key = (name, path)
    if key not in _DS_CACHE:
        _DS_CACHE[key] = _load_node_dataset_uncached(name, path)
    return _DS_CACHE[key]


def probe_num_classes(args):
    """Number of classes of the dataset the loop will load (cora 7,
    citeseer 6, pubmed 3, the synthetic fallback 7)."""
    return load_node_dataset(args.dataset, args.dataset_path)[1]


def node_data(args, data=None):
    """``data`` (a dict of numpy arrays, or a `Graph`) as `node_arrays`;
    None loads ``args.dataset`` from ``args.dataset_path``."""
    if data is None:
        data = load_node_dataset(args.dataset, args.dataset_path)[0]
    return node_arrays(data) if isinstance(data, Graph) else data


def _load_node_dataset_uncached(name, path="data"):
    if name in ("cora", "citeseer", "pubmed"):
        try:
            have_raw = osp.exists(osp.join(path, name, "raw"))
            if not (have_raw or network_available()):
                raise OSError("no network (fast probe) and no raw files")
            ds = Planetoid(root=path, name=name)
            return ds[0], ds.num_classes
        except Exception as e:
            print(f"[warn] {name} unavailable ({e}); trying "
                  "real-structure fallback")
        g = _load_real_structure(name)
        if g is not None:
            return g, int(np.asarray(g.y).max()) + 1
    n, c, f = 1000, 7, 128
    if os.environ.get("GGL_REAL_SHAPES"):
        # the fallback at the dataset's true sizes (feature width, class
        # count), so shape-dependent faults show on every trainer
        n, f, c = _REAL_DIMS.get(name, (n, f, c))
    return _synthetic_graph(n, c, f, avg_degree=8, seed=0), c


# the reference repository's real Planetoid adjacencies (cora nnz 13264 =
# 2 * 5278 + 2708 self-loops; pubmed 108365 = 2 * 44324 + 19717, the
# published graphs; citeseer only as citgnn's +50%-edges variant), under
# the checkout that GGL_REFERENCE_ROOT names. Features and labels are
# derived from the structure (`structure_node_data`), so accuracy is not
# comparable to published tables.
_STRUCT_ADJ = {
    "cora": "examples/gcil/dataset/cora/0.01_1_1.npz",
    "citeseer": "examples/citgnn/datasets/citeseer_add_0.5.npz",
    "pubmed": "examples/gcil/dataset/pubmed/0.01_1_1.npz",
}
_STRUCT_CLASSES = {"cora": 7, "citeseer": 6, "pubmed": 3}

# true (num_nodes, feat_dim, num_classes) per dataset, for GGL_REAL_SHAPES
_REAL_DIMS = {
    "cora": (2708, 1433, 7),
    "citeseer": (3327, 3703, 6),
    "pubmed": (19717, 500, 3),
    "reddit": (60_000, 602, 41),     # node count capped for CPU smoke
    "arxiv": (169_343, 128, 40),
    "ogbn-arxiv": (169_343, 128, 40),
}


def _load_real_structure(name):
    """A `Graph` on a real Planetoid adjacency with node data derived
    from it (`structure_node_data`), or None: with ``GGL_SYNTHETIC`` set,
    or without the adjacency file. The derived arrays are cached in
    ``data/<name>/struct_cache_f<F>.npz`` under the working directory
    (numpy arrays only, the JAX package's file)."""
    ref = os.environ.get("GGL_REFERENCE_ROOT")
    if os.environ.get("GGL_SYNTHETIC") or not ref or name not in _STRUCT_ADJ:
        return None
    adj = osp.join(ref, _STRUCT_ADJ[name])
    if not osp.exists(adj):
        return None
    c = _STRUCT_CLASSES[name]
    f = _REAL_DIMS[name][1] if os.environ.get("GGL_REAL_SHAPES") else 128
    ei, n = load_sparse_npz(adj)
    cache = osp.join("data", name, f"struct_cache_f{f}.npz")
    try:
        d = np.load(cache)
        x, y = d["x"], d["y"]
        tm, vm, sm = d["train_mask"], d["val_mask"], d["test_mask"]
    except Exception:
        x, y, tm, vm, sm = structure_node_data(ei, n, num_classes=c,
                                               feat_dim=f)
        try:
            os.makedirs(osp.dirname(cache), exist_ok=True)
            np.savez(cache, x=x, y=y, train_mask=tm, val_mask=vm,
                     test_mask=sm)
        except OSError:
            pass
    g = Graph(x=x, edge_index=ei, y=y.astype(np.int64), train_mask=tm,
              val_mask=vm, test_mask=sm)
    g.data_kind = "real-structure"
    return g


def load_sparse_npz(path):
    """A scipy-format .npz, COO ('row' / 'col') or CSR ('indptr' /
    'indices'), as (edge_index, num_nodes)."""
    d = np.load(path, allow_pickle=True)
    n = int(d["shape"][0])
    if "row" in d:
        ei = np.stack([d["row"], d["col"]]).astype(np.int64)
    else:
        indptr, indices = d["indptr"], d["indices"]
        row = np.repeat(np.arange(n), np.diff(indptr))
        ei = np.stack([row, indices.astype(np.int64)])
    return ei, n


def structure_node_data(ei, n, num_classes=7, seed=0, feat_dim=128):
    """Node data derived from an adjacency alone: labels by spectral
    clustering of the symmetrized graph (scikit-learn's KMeans, imported
    here only), features one smoothing step of a random signal over it,
    Planetoid's split (20 a class to train, 500 val, 1000 test). Returns
    (x, y, train_mask, val_mask, test_mask)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import eigsh
    from sklearn.cluster import KMeans
    a = sp.coo_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])),
                      shape=(n, n)).tocsr()
    a = ((a + a.T) > 0).astype(np.float64)
    d = np.asarray(a.sum(1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(d, 1))
    # the top eigenvectors of the normalized adjacency: the bottom of the
    # Laplacian without a shift-invert solve
    _, vec = eigsh(sp.diags(dinv) @ a @ sp.diags(dinv), k=num_classes,
                   which="LA")
    y = KMeans(num_classes, n_init=4, random_state=seed).fit_predict(vec)
    rng = np.random.default_rng(seed)
    x = np.asarray((a @ rng.normal(size=(n, feat_dim)))
                   / np.maximum(d, 1)[:, None]).astype(np.float32)
    perm = rng.permutation(n)
    train_mask = np.zeros(n, bool)
    for c in range(num_classes):
        train_mask[perm[y[perm] == c][:20]] = True
    rest = perm[~train_mask[perm]]
    val_mask = np.zeros(n, bool)
    val_mask[rest[:500]] = True
    test_mask = np.zeros(n, bool)
    test_mask[rest[500:1500]] = True
    return x, y, train_mask, val_mask, test_mask


def base_parser(description=None, **overrides):
    """The JAX trainers' flags and defaults (`examples/common.py`
    `base_parser`), the given overrides, and ``--device`` (default: the
    CUDA card). ``--dataset`` and ``--dataset_path`` name the graph
    `load_node_dataset` reads."""
    p = argparse.ArgumentParser(description=description)
    defaults = {"dataset": "cora", "dataset_path": "data", "lr": 0.01,
                "n_epoch": 200, "hidden_dim": 16, "drop_rate": 0.5,
                "l2_coef": 5e-4, "seed": 0}
    defaults.update(overrides)
    for name, default in defaults.items():
        p.add_argument(f"--{name}", type=type(default), default=default)
    p.add_argument("--device", default="cuda")
    return p


def loss_and_grad(model, x, edge_index, y, mask, plan=None,
                  **forward_kwargs):
    """Masked cross-entropy of one full-batch forward, and its backward:
    the gradients are left in each parameter's ``.grad``."""
    if plan is not None:
        forward_kwargs["plan"] = plan
    logits = model(x, edge_index, **forward_kwargs)
    loss = semi_supervised_loss(logits, y, mask)
    loss.backward()
    return loss.detach()


def train_step(state, x, edge_index, y, mask, plan=None, **forward_kwargs):
    """One optimizer step of the training mode model; returns the loss."""
    state.model.train()
    loss = loss_and_grad(state.model, x, edge_index, y, mask, plan,
                         **forward_kwargs)
    state.apply_gradients()
    return loss


def _init_lazy(model, in_features):
    """Give lazy layers their in-features from a one-node graph without
    edges, as flax's ``init`` does from the first input."""
    if any(isinstance(p, UninitializedParameter) for p in model.parameters()):
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, in_features),
                  torch.zeros(2, 0, dtype=torch.long))


def run_simple_node_trainer(model, args, data=None, params=None,
                            forward_kwargs=None, log_every=20):
    """Full-batch semi-supervised node classification: Adam with decayed
    weights (``args.lr``, ``args.l2_coef``) on the masked cross-entropy,
    ``args.n_epoch`` steps, validation and test accuracy after each, on
    ``args.device``.

    ``data``: a dict of numpy arrays as `synthetic_community_graph`
    returns, or a `Graph` (None: `load_node_dataset` of ``args.dataset``
    and ``args.dataset_path``); self-loops are added here.
    ``params``: a flax-shaped tree for `load_jax_params` (None: the model's
    own init from ``args.seed``). A model whose forward takes a
    ``generator`` gets one, seeded from ``args.seed + 1``, for its dropout.
    ``forward_kwargs`` go to every forward; a ``plan`` there replaces the
    CSR plan. It must be a plan of the edges the loop trains on, which are
    ``data["edge_index"]`` with self-loops appended; for the block-pair
    route, relabel ``data`` first (`Graph.reorder_rcm`), then::

        ei, _ = add_self_loops(data["edge_index"], num_nodes=n)
        plan = Graph(edge_index=ei, num_nodes=n).auto_plan()
        run_simple_node_trainer(model, args, data,
                                forward_kwargs={"plan": plan})

    Returns {"losses", "epoch_ms", "best_val", "best_test", "best_params",
    "state"}: each epoch's host milliseconds (step and evaluation, which
    ends in a sync), the test accuracy at the best validation accuracy,
    and a copy of the parameters at that epoch.
    """
    dev = resolve_device(args.device)
    data = node_data(args, data)
    n = data["x"].shape[0]
    ei, _ = add_self_loops(np.asarray(data["edge_index"]), num_nodes=n)
    x = torch.from_numpy(np.asarray(data["x"], np.float32)).to(dev)
    edge_index = torch.from_numpy(ei).to(dev)
    y = torch.from_numpy(np.asarray(data["y"])).to(dev)
    masks = {k: torch.from_numpy(np.asarray(data[k]).reshape(n)).to(dev)
             for k in ("train_mask", "val_mask", "test_mask")}
    fkw = dict(forward_kwargs or {})
    takes = inspect.signature(model.forward).parameters
    if "plan" in takes and "plan" not in fkw:
        fkw["plan"] = build_csr_plan(ei[0], ei[1], n)
    torch.manual_seed(args.seed)
    if params is not None:
        load_jax_params(model, params)
    else:
        _init_lazy(model, x.shape[1])
    state = TrainState(model.to(dev), args.lr, args.l2_coef)
    train_kw = dict(fkw)
    if "generator" in takes:
        train_kw["generator"] = torch.Generator(device=dev).manual_seed(
            args.seed + 1)

    losses, epoch_ms = [], []
    best_val, best_test, best_params = -1.0, 0.0, None
    for epoch in range(args.n_epoch):
        t0 = time.perf_counter()
        loss = float(train_step(state, x, edge_index, y, masks["train_mask"],
                                **train_kw))
        logits = predict(model, x, edge_index, **fkw)
        val = float(accuracy(logits, y, masks["val_mask"]))
        test = float(accuracy(logits, y, masks["test_mask"]))
        epoch_ms.append((time.perf_counter() - t0) * 1e3)  # .item() synced
        losses.append(loss)
        if val > best_val:
            best_val, best_test = val, test
            best_params = copy.deepcopy(model.state_dict())
        if epoch % log_every == 0:
            print(f"epoch {epoch:4d} loss {loss:.4f} val {val:.4f} "
                  f"test {test:.4f}")
    print(f"best val {best_val:.4f} -> test {best_test:.4f} ({dev})")
    return {"losses": losses, "epoch_ms": epoch_ms, "best_val": best_val,
            "best_test": best_test, "best_params": best_params,
            "state": state}


def synthetic_hetero(seed=0, n_m=200, n_d=60, c=3, f=32):
    """The JAX package's synthetic movie/director graph
    (`examples/common.py` `synthetic_hetero`), drawn from the same numpy
    stream: classes shape which director made a movie, a 2.0 class signal
    in the movie features, a movie-director-movie relation, and half the
    movies for training. Returns (HeteroGraph, "movie")."""
    rng = np.random.default_rng(seed)
    hg = HeteroGraph()
    y = rng.integers(0, c, n_m)
    x = rng.normal(size=(n_m, f)).astype(np.float32)
    x[np.arange(n_m), y] += 2.0
    hg["movie"].x = x
    hg["movie"].y = y
    hg["director"].x = rng.normal(size=(n_d, f)).astype(np.float32)
    d_of = rng.integers(0, n_d // c, n_m) + (n_d // c) * y
    hg[("director", "directs", "movie")].edge_index = np.stack(
        [d_of, np.arange(n_m)])
    hg[("movie", "by", "director")].edge_index = np.stack(
        [np.arange(n_m), d_of])
    mdm = [(a, b) for d in range(n_d) for a in np.nonzero(d_of == d)[0]
           for b in np.nonzero(d_of == d)[0]]
    hg[("movie", "mdm", "movie")].edge_index = np.asarray(mdm).T
    mask = np.zeros(n_m, bool)
    mask[rng.permutation(n_m)[:n_m // 2]] = True
    hg["movie"].train_mask = mask
    hg["movie"].test_mask = ~mask
    return hg, "movie"


def hetero_tensors(hg, target, device):
    """(x_dict, edge_index_dict, y, train_mask, test_mask) of ``hg`` as
    tensors on ``device``: features float32, labels and masks of the
    target type."""
    def put(a, dtype=None):
        a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
        return torch.from_numpy(a).to(device)

    x_dict = {nt: put(x, np.float32) for nt, x in hg.x_dict.items()}
    ei_dict = {et: put(ei) for et, ei in hg.edge_index_dict.items()}
    store = hg[target]
    return (x_dict, ei_dict, put(store.y), put(store.train_mask),
            put(store.test_mask))


def predict(model, x, edge_index, **forward_kwargs):
    """The eval-mode forward, without gradients: how the loops score a
    model, and how a typed-graph model is served (the JAX package serves
    hetero models by its trainer's eval forward too)."""
    model.eval()
    with torch.no_grad():
        return model(x, edge_index, **forward_kwargs)


def staged_dataset(cls, root, **kwargs):
    """``cls(root=root, **kwargs)`` read from the raw files already under
    ``root``; OSError, naming a missing file, before any folder is made
    or anything fetched. (The dataset classes fetch missing raw files,
    as the JAX package's do; the twins read staged files only.)"""
    probe = object.__new__(cls)
    probe.root = osp.expanduser(root)
    for key, value in kwargs.items():
        setattr(probe, key, value.lower() if key == "name" else value)
    missing = [p for p in probe.raw_paths if not osp.exists(p)]
    if missing:
        raise OSError(f"{cls.__name__}: no staged file {missing[0]}")
    return cls(root=root, **kwargs)


def load_imdb(args):
    """IMDB from ``args.dataset_path`` (`staged_dataset`), the JAX
    trainers' ``load_imdb``: (HeteroGraph, "movie")."""
    return staged_dataset(IMDB, args.dataset_path)[0], "movie"


def run_hetero_trainer(make_model, args, data=None, params=None,
                       log_every=10, dataset_loader=None):
    """Typed-graph node classification, the JAX `run_hetero_trainer`'s
    loop: ``args.n_epoch`` steps of Adam (``args.lr``, no decay) on the
    masked cross-entropy of the target type in training mode, and test
    accuracy in eval mode every ``log_every`` epochs and at the end, on
    ``args.device``. ``make_model(metadata, num_classes, target,
    in_channels)`` builds the model; a forward that takes ``plan_dict``
    gets `HeteroGraph.csr_plans()` on the card, and one that takes a
    ``generator`` gets one seeded from ``args.seed + 1`` for its attention
    dropout. ``data``: (HeteroGraph, target type); None takes
    ``dataset_loader(args)`` and, when that raises (or there is no
    loader), `synthetic_hetero` with the JAX loop's warning line.
    ``params``: a flax-shaped tree for `load_jax_params` (None: the
    model's own init from ``args.seed``).

    Returns {"losses", "test_acc", "state"}.
    """
    dev = resolve_device(args.device)
    if data is None and dataset_loader is not None:
        try:
            data = dataset_loader(args)
        except Exception as e:
            print(f"[warn] dataset unavailable ({e}); synthetic typed graph")
    hg, target = data if data is not None else synthetic_hetero()
    x_dict, ei_dict, y, train_mask, test_mask = hetero_tensors(hg, target,
                                                               dev)
    torch.manual_seed(args.seed)
    model = make_model(hg.metadata(), int(y.max()) + 1, target,
                       {nt: x.shape[1] for nt, x in x_dict.items()})
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    takes = inspect.signature(model.forward).parameters
    fkw = {}
    if "plan_dict" in takes and dev.type == "cuda":
        fkw["plan_dict"] = hg.csr_plans()
    train_kw = dict(fkw)
    if "generator" in takes:
        train_kw["generator"] = torch.Generator(device=dev).manual_seed(
            args.seed + 1)

    def test_acc():
        return float(accuracy(predict(model, x_dict, ei_dict, **fkw), y,
                              test_mask))

    losses = []
    for epoch in range(args.n_epoch):
        state.model.train()
        loss = loss_and_grad(model, x_dict, ei_dict, y, train_mask,
                             **train_kw)
        state.apply_gradients()
        losses.append(float(loss))
        if epoch % log_every == 0 or epoch == args.n_epoch - 1:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"test {test_acc():.4f}")
    acc = test_acc()
    print(f"final test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "state": state}


def run_edge_type_trainer(model, args, x, edge_index, edge_type, y,
                          train_mask, test_mask, params=None,
                          log_every=10):
    """Node classification on one node set whose edges carry a type, the
    loop of the JAX rgcn and simplehgn trainers: ``args.n_epoch`` steps of
    Adam (``args.lr``, no decay) on the masked cross-entropy of the first
    ``len(y)`` rows of the logits, their test accuracy every ``log_every``
    epochs (before that epoch's step, as the JAX loops read the step's own
    logits) and at the end, on ``args.device``.

    The arrays are numpy; on the card the model gets a `CSRPlan` of the
    edges (``plan=``), so its sums run the kernels; on the CPU it takes the
    COO route. ``params``: a flax-shaped tree for `load_jax_params` (None:
    the model's own init). Returns {"losses", "test_acc", "state"}.
    """
    dev = resolve_device(args.device)

    def put(a, dtype=None):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    x, ei, et, y = put(x, np.float32), put(edge_index), put(edge_type), put(y)
    train_mask, test_mask = put(train_mask), put(test_mask)
    fkw = {"edge_type": et}
    if dev.type == "cuda":
        fkw["plan"] = build_csr_plan(edge_index[0], edge_index[1],
                                     x.shape[0])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    n = y.shape[0]

    def test_acc():
        return float(accuracy(predict(model, x, ei, **fkw)[:n], y,
                              test_mask))

    losses = []
    for epoch in range(args.n_epoch):
        acc = test_acc() if epoch % log_every == 0 else None
        state.model.train()
        loss = semi_supervised_loss(model(x, ei, **fkw)[:n], y, train_mask)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if acc is not None:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} test {acc:.4f}")
    acc = test_acc()
    print(f"final test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "state": state}


def linear_probe(emb, d, num_classes, steps=300, lr=1e-2):
    """Test accuracy of a logistic regression on frozen embeddings, the
    JAX examples' shared evaluation of self-supervised models
    (`examples/common.py` `linear_probe`): the rows of ``emb`` normalised
    to unit length (+1e-12), a zero-initialised map to ``num_classes``
    trained by ``steps`` Adam steps at ``lr`` on the masked cross-entropy
    of ``d["y"]`` over ``d["train_mask"]``, scored on ``d["test_mask"]``
    (tensors on emb's device)."""
    emb = emb.detach().float()
    emb = emb / (torch.linalg.vector_norm(emb, dim=1, keepdim=True) + 1e-12)
    w = torch.zeros(emb.shape[1], num_classes, device=emb.device,
                    requires_grad=True)
    opt = torch.optim.Adam([w], lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        semi_supervised_loss(emb @ w, d["y"], d["train_mask"]).backward()
        opt.step()
    with torch.no_grad():
        return float(accuracy(emb @ w, d["y"], d["test_mask"]))


def binary_auc(scores, labels):
    """ROC AUC by the rank statistic, ties given their average rank (the
    JAX examples' ``binary_auc``): P(positive score > negative score);
    0.5 when a class is empty. Numpy in, float out."""
    scores = np.asarray(scores, np.float64).ravel()
    labels = np.asarray(labels).ravel().astype(bool)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    sorted_s = scores[order]
    i = 0
    while i < len(sorted_s):
        j = i
        while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def device_graph(data, device):
    """The JAX examples' ``device_graph``: x, the edges with self-loops
    appended, y and the three masks of ``data`` (a dict of numpy arrays,
    `node_arrays`) as tensors on ``device``."""
    n = data["x"].shape[0]
    ei, _ = add_self_loops(np.asarray(data["edge_index"]), num_nodes=n)
    out = {"x": torch.from_numpy(np.asarray(data["x"], np.float32)),
           "edge_index": torch.from_numpy(ei),
           "y": torch.from_numpy(np.asarray(data["y"]))}
    for k in ("train_mask", "val_mask", "test_mask"):
        out[k] = torch.from_numpy(np.asarray(data[k]).reshape(n))
    return {k: v.to(device) for k, v in out.items()}


def run_two_view_ssl(model, args, embed_fn, drop_rates=(0.2, 0.2, 0.3, 0.3),
                     data=None, params=None, draws=None, log_every=20):
    """The JAX examples' loop for two-view contrastive models whose
    forward is (x1, ei, w1, x2, ei, w2) -> loss (`examples/common.py`
    `run_two_view_ssl`): each step augments two views with
    `drop_edge_and_feature`, takes an Adam step (``args.lr``), then a
    `linear_probe` on ``embed_fn(model, x, edge_index)``.

    The rates are ``drop_rates = (edge1, feat1, edge2, feat2)``, or the
    ``args`` attributes ``drop_edge_rate_{1,2}`` / ``drop_feature_rate_
    {1,2}`` where they exist. The call keeps JAX's argument order:
    ``drop_edge_and_feature(x, ei, edge_rate, feature_rate)`` against the
    signature ``(x, edge_index, feat_drop, edge_drop)``, so the edge rate
    masks the features and the feature rate drops the edges (ROADMAP
    C27). The masks are drawn from a generator on ``args.device`` seeded
    ``args.seed + 1``, or taken from ``draws``: an iterator giving
    ((feature mask, edge mask) of view a, the same of view b) each step.
    ``data`` and ``params`` as in `run_simple_node_trainer`.

    Returns {"losses", "probe_acc", "state"}.
    """
    from gammagl_tpu_torch.models import drop_edge_and_feature

    de1 = getattr(args, "drop_edge_rate_1", drop_rates[0])
    df1 = getattr(args, "drop_feature_rate_1", drop_rates[1])
    de2 = getattr(args, "drop_edge_rate_2", drop_rates[2])
    df2 = getattr(args, "drop_feature_rate_2", drop_rates[3])
    dev = resolve_device(args.device)
    data = node_data(args, data)
    num_classes = int(np.asarray(data["y"]).max()) + 1
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    for epoch in range(args.n_epoch):
        (fa, ea), (fb, eb) = next(draws) if draws is not None else (
            (None, None), (None, None))
        xa, wa = drop_edge_and_feature(x, ei, de1, df1, gen, fa, ea)
        xb, wb = drop_edge_and_feature(x, ei, de2, df2, gen, fb, eb)
        model.train()
        loss = model(xa, ei, wa, xb, ei, wb)
        loss.backward()
        state.apply_gradients()
        losses.append(loss.detach())
        if epoch % log_every == 0 or epoch == args.n_epoch - 1:
            print(f"pretrain {epoch:4d} loss {float(losses[-1]):.4f}")
    model.eval()
    with torch.no_grad():
        emb = embed_fn(model, x, ei)
    acc = linear_probe(emb, d, num_classes)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": [float(v) for v in losses], "probe_acc": acc,
            "state": state}


def run_corruption_ssl(model, args, views=lambda d: (), data=None,
                       params=None, draws=None, n_steps=None, log_every=20):
    """The loop the JAX DGI, GGD and MVGRL examples share: each step
    corrupts x by a row permutation (`corrupt_features`), takes an Adam
    step (``args.lr``) on ``model(x, ei, *views(d), x_corrupt)``, then a
    `linear_probe` on the embeddings ``model(x, ei, *views(d))``.

    ``views(d)`` gives the model's extra inputs from the device graph
    (MVGRL's diffusion edges and weights). ``n_steps`` defaults to
    ``args.n_epoch``. The permutations are drawn from a generator on
    ``args.device`` seeded ``args.seed + 1``, or taken from ``draws``, an
    iterator of permutations. ``data`` and ``params`` as in
    `run_simple_node_trainer`. Returns {"losses", "probe_acc", "state"}.
    """
    from gammagl_tpu_torch.models import corrupt_features

    dev = resolve_device(args.device)
    data = node_data(args, data)
    num_classes = int(np.asarray(data["y"]).max()) + 1
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    extra = views(d)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    n_steps = args.n_epoch if n_steps is None else n_steps
    for step in range(n_steps):
        xc = corrupt_features(x, gen, None if draws is None else next(draws))
        model.train()
        loss = model(x, ei, *extra, xc)
        loss.backward()
        state.apply_gradients()
        losses.append(loss.detach())
        if step % log_every == 0 or step == n_steps - 1:
            print(f"pretrain {step:4d} loss {float(losses[-1]):.4f}")
    model.eval()
    with torch.no_grad():
        emb = model(x, ei, *extra)
    acc = linear_probe(emb, d, num_classes)
    print(f"probe test acc {acc:.4f} ({dev})")
    return {"losses": [float(v) for v in losses], "probe_acc": acc,
            "state": state}
