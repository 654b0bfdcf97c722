"""CIT-GNN trainer: a GCN with mincut cluster regularizers, tested on a
structure-shifted graph.

Twin of `examples/citgnn/citgnn_trainer.py`: a 2-layer `GCNModel` and a
cluster-assignment head (`AssignmentMLP`, flax ``Dense_0``) trained on the
clean graph with loss 0.55 * CE + 0.25 * mincut + 0.2 * ortho
(`layers.pool.sparse_mincut_losses` on the first layer's ReLU features,
from the edge list: no N x N adjacency), Adam with decayed weights; each
epoch validation accuracy on the clean graph and test accuracy on the
shifted one, the test accuracy at the best validation kept. The graph:
with ``--real_structure`` and the reference checkout that
``GGL_REFERENCE_ROOT`` names, the real Planetoid adjacencies (train
``examples/gcil/dataset/<name>/0.01_1_1.npz``, test
``examples/citgnn/datasets/<name>_add_<ss>.npz``) with node data derived
from the structure; else the dataset (`load_node_dataset`) and, as the
shifted graph, its edges plus ``--ss`` times as many random ones from
``np.random.default_rng(--seed)``. The same flags, plus ``--device``.
COO on every device, as in JAX.

    python -m gammagl_tpu_torch.examples.citgnn_trainer              # the card
    python -m gammagl_tpu_torch.examples.citgnn_trainer --device cpu
"""

import os
import os.path as osp

import numpy as np
import torch
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser,
                                               load_node_dataset,
                                               load_sparse_npz, node_arrays,
                                               structure_node_data)
from gammagl_tpu_torch.layers.dense import lecun_apply, lecun_dense
from gammagl_tpu_torch.layers.pool import sparse_mincut_losses
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import (add_self_loops, calc_gcn_norm,
                                     load_jax_params, resolve_device)

__all__ = ["AssignmentMLP", "parser", "main", "shifted_graphs", "shift_edges"]


class AssignmentMLP(nn.Module):
    """The cluster-assignment head (reference utils.py
    AssignmentMatricsMLP): one map to the cluster logits;
    `sparse_mincut_losses` applies the softmax."""

    def __init__(self, num_clusters, in_channels=None):
        super().__init__()
        self.lin = lecun_dense(in_channels, num_clusters)

    def flax_tree(self):
        return {"Dense_0": self.lin}

    def forward(self, h):
        return lecun_apply(self.lin, h)


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=200,
                    lr=0.005)
    p.add_argument("--clusters", type=int, default=100)
    p.add_argument("--ss", type=str, default="0.5",
                   help="structure-shift ratio of the test adjacency")
    p.add_argument("--real_structure", type=int, default=1)
    return p


def _real_structure(name, ss, seed, num_classes=7):
    ref = os.environ.get("GGL_REFERENCE_ROOT")
    if not ref:
        return None
    gcil = osp.join(ref, "examples", "gcil", "dataset")
    cit = osp.join(ref, "examples", "citgnn", "datasets")
    train_src = osp.join(gcil, name, "0.01_1_1.npz")
    test_src = osp.join(cit, f"{name}_add_{ss}.npz")
    if not osp.exists(test_src):
        return None
    if not osp.exists(train_src):
        train_src = osp.join(cit, f"{name}_add_0.5.npz")
        test_src = osp.join(cit, f"{name}_add_0.75.npz")
    ei_tr, n = load_sparse_npz(train_src)
    ei_te, n2 = load_sparse_npz(test_src)
    assert n == n2, (n, n2)
    x, y, tm, vm, sm = structure_node_data(ei_tr, n, num_classes, seed)
    return dict(x=x, y=y, edge_index=ei_tr, test_edge_index=ei_te,
                train_mask=tm, val_mask=vm, test_mask=sm)


def shifted_graphs(args, data=None):
    """The twin's arrays: a dict of `node_arrays` plus
    ``test_edge_index``, the shifted structure (both without
    self-loops)."""
    if data is not None:
        return data
    if args.real_structure:
        try:
            real = _real_structure(args.dataset, args.ss, args.seed)
        except Exception as e:
            print(f"[warn] real structure unavailable ({e})")
            real = None
        if real is not None:
            return real
    out = node_arrays(load_node_dataset(args.dataset, args.dataset_path)[0])
    out["test_edge_index"] = shift_edges(out["edge_index"],
                                         out["x"].shape[0], args.ss,
                                         args.seed)
    return out


def shift_edges(edge_index, num_nodes, ss, seed):
    """The synthetic structure shift (the ``_add_<ss>`` protocol): the
    edges and ``ss`` times as many random pairs, drawn from
    ``np.random.default_rng(seed)``."""
    ei = np.asarray(edge_index)
    rng = np.random.default_rng(seed)
    extra = rng.integers(0, num_nodes, (2, int(ei.shape[1] * float(ss))))
    return np.concatenate([ei, extra], axis=1)


def main(args, data=None, params=None):
    """Train; returns {"losses", "best_test", "state"}. ``data``: the
    arrays of `shifted_graphs` (None: built from ``args``). ``params``:
    {"gcn": flax tree, "head": flax tree} for `load_jax_params` (None:
    the models' own init)."""
    dev = resolve_device(args.device)
    data = shifted_graphs(args, data)
    n = data["x"].shape[0]
    num_classes = int(np.asarray(data["y"]).max()) + 1

    def graph(ei):
        ei, _ = add_self_loops(np.asarray(ei), num_nodes=n)
        ei = torch.from_numpy(ei).to(dev)
        return ei, calc_gcn_norm(ei, n)

    ei_tr, w_tr = graph(data["edge_index"])
    ei_te, w_te = graph(data["test_edge_index"])
    x = torch.from_numpy(np.asarray(data["x"], np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(data["y"])).to(dev)
    masks = {k: torch.from_numpy(np.asarray(data[k]).reshape(n, -1)[:, 0]
                                 ).to(dev)
             for k in ("train_mask", "val_mask", "test_mask")}
    torch.manual_seed(args.seed)
    model = GCNModel(hidden_dim=args.hidden_dim, num_class=num_classes,
                     drop_rate=args.drop_rate)
    head = AssignmentMLP(args.clusters, in_channels=args.hidden_dim)
    if params is not None:
        load_jax_params(model, params["gcn"])
        load_jax_params(head, params["head"])
    both = nn.ModuleDict({"gcn": model, "head": head}).to(dev)
    state = TrainState(both, args.lr, args.l2_coef)

    def first_layer(ei, w):  # the reference SemiSpvzLoss's features
        return torch.relu(model.convs[0](x, ei, w))

    losses, best_val, best_test = [], -1.0, 0.0
    for epoch in range(args.n_epoch):
        both.train()
        logits = model(x, ei_tr, w_tr)
        ce = semi_supervised_loss(logits, y, masks["train_mask"])
        h = first_layer(ei_tr, w_tr)
        mc, ortho = sparse_mincut_losses(head(h), ei_tr, n)
        loss = 0.55 * ce + 0.25 * mc + 0.2 * ortho
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        both.eval()
        with torch.no_grad():  # val on the clean graph, test on the shift
            val = float(accuracy(model(x, ei_tr, w_tr), y,
                                 masks["val_mask"]))
            test = float(accuracy(model(x, ei_te, w_te), y,
                                  masks["test_mask"]))
        if val > best_val:
            best_val, best_test = val, test
        if epoch % 20 == 0:
            print(f"epoch {epoch:4d} loss {losses[-1]:.4f} val {val:.4f} "
                  f"test {test:.4f}")
    print(f"best val {best_val:.4f} -> shifted test {best_test:.4f} ({dev})")
    return {"losses": losses, "best_test": best_test, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
