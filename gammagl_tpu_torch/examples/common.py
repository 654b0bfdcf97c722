"""What the trainer twins share: the synthetic graphs, the flags and the
full-batch node-classification loops (counterpart of `examples/common.py`'s
`base_parser`, `run_simple_node_trainer`, `synthetic_hetero` and
`run_hetero_trainer`).

The loops read no dataset files: the graph is `synthetic_community_graph`
(the JAX package's stochastic-block-model graph, drawn from the same numpy
stream) or numpy arrays handed in, and for typed graphs `synthetic_hetero`
(the JAX package's movie/director graph, the same stream) or a
`HeteroGraph` handed in; `run_edge_type_trainer` trains a model of one
node set whose edges carry a type (RGCN, SimpleHGN) on arrays handed in.
The homogeneous loop hands the model a `CSRPlan` when its forward takes
one, on the card and on the CPU alike: on the card the plan path runs the
hand-written kernels, on the CPU their plain versions. The typed loops
hand the model plans (`HeteroGraph.csr_plans()`, or the edges' `CSRPlan`)
on the card, where the JAX loops hand theirs to a TPU; on the CPU they
take the COO route. (The JAX loops plan only on a TPU, where their
kernels are not interpreted.)
"""

import argparse
import copy
import inspect

import numpy as np
import torch
from torch.nn.parameter import UninitializedParameter

from gammagl_tpu_torch.data import HeteroGraph
from gammagl_tpu_torch.ops.cuda import build_csr_plan
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import (add_self_loops, load_jax_params,
                                     resolve_device)

__all__ = ["synthetic_community_graph", "base_parser", "loss_and_grad",
           "train_step", "run_simple_node_trainer", "synthetic_hetero",
           "hetero_tensors", "predict", "run_hetero_trainer",
           "run_edge_type_trainer"]


def synthetic_community_graph(num_nodes=1000, num_classes=7, feat_dim=128,
                              avg_degree=8, p_intra=0.9, seed=0,
                              feature_signal=0.3):
    """The stochastic-block-model graph of
    `gammagl_tpu.datasets.synthetic_community_graph`, drawn from the same
    numpy stream: returns a dict of numpy arrays (x, edge_index, y and
    the train/val/test masks)."""
    rng = np.random.default_rng(seed)
    per = num_nodes // num_classes
    y = np.minimum(np.arange(num_nodes) // per, num_classes - 1)
    E = num_nodes * avg_degree // 2
    src = rng.integers(0, num_nodes, E)
    same = rng.random(E) < p_intra
    tgt_class = np.where(same, y[src],
                         (y[src] + rng.integers(1, num_classes, E))
                         % num_classes)
    dst = np.minimum(tgt_class * per + rng.integers(0, per, E),
                     num_nodes - 1)
    both = np.concatenate([np.stack([src, dst]), np.stack([dst, src])], 1)
    key = np.unique(both[0].astype(np.int64) * num_nodes + both[1])
    edge_index = np.stack([key // num_nodes, key % num_nodes])
    x = (rng.normal(size=(num_nodes, feat_dim)).astype(np.float32)
         + feature_signal * np.eye(num_classes, feat_dim,
                                   dtype=np.float32)[y])
    data = {"x": x, "edge_index": edge_index, "y": y.astype(np.int64)}
    perm = rng.permutation(num_nodes)
    n_tr, n_va = int(0.4 * num_nodes), int(0.2 * num_nodes)
    for name, idx in (("train_mask", perm[:n_tr]),
                      ("val_mask", perm[n_tr:n_tr + n_va]),
                      ("test_mask", perm[n_tr + n_va:])):
        mask = np.zeros(num_nodes, bool)
        mask[idx] = True
        data[name] = mask
    return data


def base_parser(description=None, **overrides):
    """The JAX trainers' flags and defaults (`examples/common.py`
    `base_parser`), the given overrides, and ``--device`` (default: the
    CUDA card). ``--dataset`` and ``--dataset_path`` only name the run."""
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

    ``data``: a dict of numpy arrays as `synthetic_community_graph` returns
    (None: that graph from ``args.seed``); self-loops are added here.
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

    Returns {"losses", "best_val", "best_test", "best_params", "state"}:
    the test accuracy at the best validation accuracy, and a copy of the
    parameters at that epoch.
    """
    dev = resolve_device(args.device)
    if data is None:
        data = synthetic_community_graph(seed=args.seed)
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

    losses, best_val, best_test, best_params = [], -1.0, 0.0, None
    for epoch in range(args.n_epoch):
        loss = float(train_step(state, x, edge_index, y, masks["train_mask"],
                                **train_kw))
        logits = predict(model, x, edge_index, **fkw)
        val = float(accuracy(logits, y, masks["val_mask"]))
        test = float(accuracy(logits, y, masks["test_mask"]))
        losses.append(loss)
        if val > best_val:
            best_val, best_test = val, test
            best_params = copy.deepcopy(model.state_dict())
        if epoch % log_every == 0:
            print(f"epoch {epoch:4d} loss {loss:.4f} val {val:.4f} "
                  f"test {test:.4f}")
    print(f"best val {best_val:.4f} -> test {best_test:.4f} ({dev})")
    return {"losses": losses, "best_val": best_val, "best_test": best_test,
            "best_params": best_params, "state": state}


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


def run_hetero_trainer(make_model, args, data=None, params=None,
                       log_every=10):
    """Typed-graph node classification, the JAX `run_hetero_trainer`'s
    loop: ``args.n_epoch`` steps of Adam (``args.lr``, no decay) on the
    masked cross-entropy of the target type in training mode, and test
    accuracy in eval mode every ``log_every`` epochs and at the end, on
    ``args.device``. ``make_model(metadata, num_classes, target,
    in_channels)`` builds the model; a forward that takes ``plan_dict``
    gets `HeteroGraph.csr_plans()` on the card, and one that takes a
    ``generator`` gets one seeded from ``args.seed + 1`` for its attention
    dropout. ``data``: (HeteroGraph, target type), None for
    `synthetic_hetero`; ``params``: a flax-shaped tree for
    `load_jax_params` (None: the model's own init from ``args.seed``).

    Returns {"losses", "test_acc", "state"}.
    """
    dev = resolve_device(args.device)
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
