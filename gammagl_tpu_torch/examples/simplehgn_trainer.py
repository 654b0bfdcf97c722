"""SimpleHGN trainer: SimpleHGNModel on a typed graph through the expand,
segment and SpMM kernels.

Twin of `examples/simplehgn/simplehgn_trainer.py`: the same model
(`SimpleHGNModel`, two layers of 2 heads x ``--hidden_dim``, no attention
dropout), the same graph (the synthetic movie/director graph with its
node types flattened into one set, movies first, and each relation an
edge type), the same loop (`examples.common.run_edge_type_trainer`: Adam
on the movies' masked cross-entropy) and the same flags, plus
``--device``. On the card the model gets the edges' `CSRPlan`: the
destination scores ride the expand kernel, the softmax the segment max,
expand and segment sum kernels, and each head's weighted sum the CSR SpMM
(its dalpha the SDDMM); on the CPU the COO route runs in plain PyTorch.

    python -m gammagl_tpu_torch.examples.simplehgn_trainer    # the card
    python -m gammagl_tpu_torch.examples.simplehgn_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser,
                                               run_edge_type_trainer,
                                               synthetic_hetero)
from gammagl_tpu_torch.models import SimpleHGNModel
from gammagl_tpu_torch.utils import resolve_device

__all__ = ["typed_graph", "parser", "main"]


def typed_graph(hg=None):
    """The JAX trainer's homogeneous view of a typed graph (None: the
    synthetic movie/director graph): node types stacked in
    ``hg.node_types`` order with their ids offset, edge type t = the t-th
    relation of ``hg.edge_index_dict``. Returns a dict of numpy arrays
    (x, edge_index, edge_type, and y, train_mask, test_mask of the first
    type, whose rows come first) and num_relations."""
    hg = synthetic_hetero()[0] if hg is None else hg
    offs, n = {}, 0
    for nt in hg.node_types:
        offs[nt] = n
        n += hg[nt].x.shape[0]
    eis, etypes = [], []
    for t, ((st, _, dt), ei) in enumerate(hg.edge_index_dict.items()):
        ei = np.asarray(ei)
        eis.append(np.stack([ei[0] + offs[st], ei[1] + offs[dt]]))
        etypes.append(np.full(ei.shape[1], t))
    first = hg[hg.node_types[0]]
    return {"x": np.concatenate([np.asarray(hg[nt].x)
                                 for nt in hg.node_types]),
            "edge_index": np.concatenate(eis, axis=1),
            "edge_type": np.concatenate(etypes),
            "y": np.asarray(first.y), "train_mask": first.train_mask,
            "test_mask": first.test_mask, "num_relations": len(eis)}


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                       lr=0.005)


def main(args, data=None, params=None):
    """Train; returns what `run_edge_type_trainer` returns. ``data`` is a
    dict as `typed_graph` returns (None: the synthetic graph's); ``params``
    an optional flax-shaped tree for `load_jax_params`."""
    resolve_device(args.device)
    data = typed_graph() if data is None else data
    torch.manual_seed(args.seed)
    model = SimpleHGNModel(data["num_relations"], args.hidden_dim,
                           int(np.asarray(data["y"]).max()) + 1, heads=2,
                           drop_rate=0.0, in_channels=data["x"].shape[1])
    return run_edge_type_trainer(
        model, args, data["x"], data["edge_index"], data["edge_type"],
        data["y"], data["train_mask"], data["test_mask"], params=params)


if __name__ == "__main__":
    main(parser().parse_args())
