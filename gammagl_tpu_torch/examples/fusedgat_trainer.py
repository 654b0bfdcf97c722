"""FusedGAT trainer: GAT through the fused attention kernels.

Twin of `examples/fusedgat/fusedgat_trainer.py`: the same model (two
GATConvs with a `CSRPlan`, no dropout), the same full-batch step (masked
cross-entropy, Adam) and the same flags, plus ``--device``. On a card
every GATConv runs the hand-written flash attention kernels forward and
backward, and the feature gradients go through the CSR SpMM kernel; on
the CPU the same calls run their plain versions.

    python -m gammagl_tpu_torch.examples.fusedgat_trainer              # the card
    python -m gammagl_tpu_torch.examples.fusedgat_trainer --device cpu

The graph is the JAX trainer's: `load_node_dataset` of ``--dataset``
under ``--dataset_path`` (Planetoid's raw files, else the synthetic
community graph: 1000 nodes, 7 classes, 128 features, average degree 8,
seed 0), or the numpy arrays given to `main`. Like the JAX trainer it
reads neither ``--drop_rate`` nor ``--l2_coef``.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gammagl_tpu_torch.examples.common import (base_parser, loss_and_grad,
                                               node_data,
                                               synthetic_community_graph,
                                               train_step)
from gammagl_tpu_torch.layers.conv import GATConv
from gammagl_tpu_torch.ops.cuda import build_csr_plan
from gammagl_tpu_torch.train import TrainState, accuracy
from gammagl_tpu_torch.utils import (add_self_loops, load_jax_params,
                                     resolve_device)

__all__ = ["FusedGAT", "synthetic_community_graph", "loss_and_grad",
           "train_step", "parser", "main"]


class FusedGAT(nn.Module):
    """GATConv(hidden_dim x heads) -> ELU -> GATConv(num_class, 1 head),
    no dropout; flax names ``GATConv_0``, ``GATConv_1``."""

    def __init__(self, hidden_dim=8, heads=8, num_class=7, in_channels=None,
                 dtype=None):
        super().__init__()
        self.convs = nn.ModuleList([
            GATConv(in_channels, hidden_dim, heads=heads, dtype=dtype),
            GATConv(hidden_dim * heads, num_class, heads=1, dtype=dtype)])

    def flax_tree(self):
        return {f"GATConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, plan=None):
        x = F.elu(self.convs[0](x, edge_index, plan=plan))
        return self.convs[1](x, edge_index, plan=plan)


def parser():
    return base_parser(__doc__.splitlines()[0], lr=0.005, n_epoch=100,
                       hidden_dim=8, heads=8)


def main(args, data=None, params=None):
    """Train; returns {"losses": [...], "test_acc": float}. ``data`` is a
    dict of numpy arrays as `synthetic_community_graph` returns, or a
    `Graph` (None: `load_node_dataset`'s graph); ``params`` an optional
    flax-shaped tree for `load_jax_params` (None: a fresh init from
    ``args.seed``)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    n = data["x"].shape[0]
    ei, _ = add_self_loops(np.asarray(data["edge_index"]), num_nodes=n)
    plan = build_csr_plan(ei[0], ei[1], n)
    x = torch.from_numpy(np.asarray(data["x"], np.float32)).to(dev)
    edge_index = torch.from_numpy(ei).to(dev)
    y = torch.from_numpy(np.asarray(data["y"])).to(dev)
    train_mask = torch.from_numpy(np.asarray(data["train_mask"])).to(dev)
    test_mask = torch.from_numpy(np.asarray(data["test_mask"])).to(dev)
    torch.manual_seed(args.seed)
    num_class = int(np.asarray(data["y"]).max()) + 1
    model = FusedGAT(args.hidden_dim, args.heads, num_class,
                     in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)

    def test_acc():
        model.eval()
        with torch.no_grad():
            return float(accuracy(model(x, edge_index, plan=plan), y,
                                  test_mask))

    losses = []
    for epoch in range(args.n_epoch):
        losses.append(float(train_step(state, x, edge_index, y, train_mask,
                                       plan)))
        if epoch % 20 == 0:
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"test {test_acc():.4f}")
    acc = test_acc()
    print(f"final test acc {acc:.4f} (fused attention path, {args.device})")
    return {"losses": losses, "test_acc": acc}


if __name__ == "__main__":
    main(parser().parse_args())
