"""RGCN trainer: RGCNModel on a typed knowledge graph through the segment
sum kernel.

Twin of `examples/rgcn/rgcn_trainer.py`: the same model (`RGCNModel`, two
RGCNConvs of ``--num_bases`` bases, hidden ``--hidden_dim``), the same
featureless entities (identity rows of ``--feat_dim`` columns), the same
loop (`examples.common.run_edge_type_trainer`: Adam on the masked
cross-entropy, test accuracy every 10 epochs) and the same flags, plus
``--device``. On the card the model gets the edges' `CSRPlan`: each
layer's messages are summed by `segment_sum_csr` and their gradient runs
the expand kernel; on the CPU the COO route runs in plain PyTorch.

    python -m gammagl_tpu_torch.examples.rgcn_trainer              # the card
    python -m gammagl_tpu_torch.examples.rgcn_trainer --device cpu

It trains on the Entities knowledge graph ``--dataset`` (aifb, mutag,
bgs, am) read from the files under ``--dataset_path`` (the JAX trainer's
``load``; staged files only, nothing is fetched) and, when they are
missing, on the JAX trainer's synthetic knowledge graph, made from numpy,
with its warning line. Entities gives labelled splits (``train_idx``,
``train_y``, ``test_idx``, ``test_y``), which `entities_data` turns into
labels and masks; the JAX trainer reads ``g.y`` and the masks, which
Entities does not set, and stops there (ROADMAP C23).
"""

import numpy as np
import torch

from gammagl_tpu_torch.datasets import Entities
from gammagl_tpu_torch.examples.common import (base_parser,
                                               run_edge_type_trainer,
                                               staged_dataset)
from gammagl_tpu_torch.models import RGCNModel
from gammagl_tpu_torch.utils import resolve_device

__all__ = ["synthetic_kg", "entities_data", "load", "parser", "main"]


def synthetic_kg(seed=0, n=500, e=4000, r=8, c=4):
    """The JAX rgcn trainer's fallback graph, drawn from the same numpy
    stream: ``r`` relations whose type sets the class of the destination
    (relation t points into class t % c), random sources, half the nodes
    for training. Returns a dict of numpy arrays (edge_index, edge_type,
    y, train_mask, test_mask) and num_nodes, num_relations."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    et = rng.integers(0, r, e)
    cand = [np.nonzero(y == k)[0] for k in range(c)]
    dst = np.array([rng.choice(cand[k]) for k in et % c])
    edge_index = np.stack([rng.integers(0, n, e), dst])
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:n // 2]] = True
    return {"edge_index": edge_index, "edge_type": et, "y": y,
            "train_mask": mask, "test_mask": ~mask, "num_nodes": n,
            "num_relations": r}


def entities_data(g):
    """The loop's arrays of an Entities graph, in `synthetic_kg`'s form:
    its edges and their types, and labels and train / test masks from its
    labelled splits (0 and unmasked where a node has no label)."""
    n = int(g.num_nodes)
    y = np.zeros(n, np.int64)
    masks = {}
    for split in ("train", "test"):
        idx = np.asarray(g[f"{split}_idx"], np.int64)
        y[idx] = np.asarray(g[f"{split}_y"])
        masks[split] = np.zeros(n, bool)
        masks[split][idx] = True
    return {"edge_index": np.asarray(g.edge_index),
            "edge_type": np.asarray(g.edge_type), "y": y,
            "train_mask": masks["train"], "test_mask": masks["test"],
            "num_nodes": n, "num_relations": int(g.num_relations)}


def load(args):
    """`entities_data` of Entities ``args.dataset`` from the staged files
    under ``args.dataset_path``, else `synthetic_kg`, as the JAX trainer's
    ``load``."""
    try:
        g = staged_dataset(Entities, args.dataset_path,
                           name=args.dataset)[0]
        return entities_data(g)
    except Exception as e:
        print(f"[warn] entities unavailable ({e}); synthetic KG")
        return synthetic_kg()


def parser():
    p = base_parser(__doc__.splitlines()[0], dataset="aifb", n_epoch=50,
                    lr=0.01, hidden_dim=16)
    p.add_argument("--num_bases", type=int, default=4)
    p.add_argument("--feat_dim", type=int, default=64)
    return p


def main(args, data=None, params=None):
    """Train; returns what `run_edge_type_trainer` returns. ``data`` is a
    dict as `synthetic_kg` returns (None: `load`); ``params`` an
    optional flax-shaped tree for `load_jax_params`."""
    resolve_device(args.device)
    data = load(args) if data is None else data
    n = data["num_nodes"]
    torch.manual_seed(args.seed)
    model = RGCNModel(args.feat_dim, args.hidden_dim,
                      int(np.asarray(data["y"]).max()) + 1,
                      data["num_relations"], num_bases=args.num_bases)
    return run_edge_type_trainer(
        model, args, np.eye(n, args.feat_dim, dtype=np.float32),
        data["edge_index"], data["edge_type"], data["y"],
        data["train_mask"], data["test_mask"], params=params)


if __name__ == "__main__":
    main(parser().parse_args())
