"""RGCN on a typed graph (hetero_rgcn) trainer, dense or expert-parallel.

Twin of `examples/hetero_rgcn/hetero_rgcn_trainer.py`: the JAX package's
synthetic movie/director graph (`common.synthetic_hetero`) flattened to
one node set with an edge type a relation (`typed_graph`), the same flags
and defaults (hidden 16, 50 epochs, Adam at 0.005), plus ``--device``.

The dense path trains `RGCNModel` (two RGCNConvs of 2 bases) in the loop
of `common.run_edge_type_trainer`; on the card the model gets the edges'
`CSRPlan`, so its sums run the segment sum kernel. ``--ep P`` trains the
expert-parallel tier (`parallel.make_relation_expert_spmm`): each of the
P processes of a ``torch.distributed`` group owns ``ceil(R / P)``
relation matrices of each layer, drawn from the JAX trainer's numpy
stream, its sums run the CSR SpMM kernel (`spmm_csr`, 4 launches a step),
one ``all_reduce`` a layer adds the partials, and each expert's gradient
stays on its owner; ``--ep`` must be the group's size.

    python -m gammagl_tpu_torch.examples.hetero_rgcn_trainer       # the card
    python -m gammagl_tpu_torch.examples.hetero_rgcn_trainer --device cpu
    torchrun --nproc-per-node 2 -m \\
        gammagl_tpu_torch.examples.hetero_rgcn_trainer --ep 2 --device cpu

Under ``torchrun`` the script joins its ``env://`` group
(`papers100m_trainer.join_launcher_group`); only rank 0 prints.
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gammagl_tpu_torch.examples.common import (base_parser,
                                               run_edge_type_trainer,
                                               synthetic_hetero)
from gammagl_tpu_torch.models import RGCNModel
from gammagl_tpu_torch.parallel import (make_relation_expert_spmm,
                                        shard_expert_weights, world)
from gammagl_tpu_torch.train import accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import resolve_device

__all__ = ["typed_graph", "ExpertRGCN", "parser", "main_ep", "main"]


def typed_graph():
    """The synthetic movie/director graph as one node set (movies first,
    then directors), its relations as edge types in the graph's order:
    a dict of numpy arrays x, edge_index, edge_type, y (the movies'),
    train_mask, test_mask, and n_m (movies) and num_relations."""
    hg, _ = synthetic_hetero()
    offs = {"movie": 0, "director": hg["movie"].x.shape[0]}
    eis, etypes = [], []
    for t, (st, rel, dt) in enumerate(hg.edge_index_dict.keys()):
        ei = np.asarray(hg.edge_index_dict[(st, rel, dt)])
        eis.append(np.stack([ei[0] + offs[st], ei[1] + offs[dt]]))
        etypes.append(np.full(ei.shape[1], t))
    y = np.asarray(hg["movie"].y)
    return {"x": np.concatenate([np.asarray(hg["movie"].x),
                                 np.asarray(hg["director"].x)]),
            "edge_index": np.concatenate(eis, axis=1),
            "edge_type": np.concatenate(etypes), "y": y,
            "n_m": y.shape[0], "num_relations": len(eis),
            "train_mask": np.asarray(hg["movie"].train_mask),
            "test_mask": np.asarray(hg["movie"].test_mask)}


class ExpertRGCN:
    """The ``--ep`` tier of this process: its blocks of the two layers'
    relation weights (``params``, from the JAX trainer's draws:
    ``normal / sqrt(fan_in)`` of ``default_rng(args.seed)``, layer 1 then
    layer 2), Adam over them (``opt``), and `step`, one training step.
    ``args.ep`` must be the size of ``group``."""

    def __init__(self, args, data, group=None):
        rank, size, group = world(group)
        if args.ep != size:
            raise ValueError(f"--ep {args.ep} but the process group has "
                             f"{size} process(es): run --ep P in a group "
                             "of P processes (torchrun)")
        self.rank, self.size = rank, size
        dev = resolve_device(args.device)

        def put(a):
            return torch.from_numpy(np.asarray(a)).to(dev)

        n, f = data["x"].shape
        self.num_classes = int(np.asarray(data["y"]).max()) + 1
        self.x, self.ei, self.et = (put(data["x"]), put(data["edge_index"]),
                                    put(data["edge_type"]))
        self.y, self.train_mask, self.test_mask = (
            put(data["y"]), put(data["train_mask"]), put(data["test_mask"]))
        self.n_m = data["n_m"]
        self.run = make_relation_expert_spmm(n, group)
        rng = np.random.default_rng(args.seed)
        R, h = data["num_relations"], args.hidden_dim
        w1 = (rng.normal(size=(R, f, h)).astype(np.float32)
              * (1.0 / np.sqrt(f)))
        w2 = (rng.normal(size=(R, h, self.num_classes)).astype(np.float32)
              * (1.0 / np.sqrt(h)))
        self.params = {
            name: shard_expert_weights(np.asarray(w, np.float32), group,
                                       dev).requires_grad_()
            for name, w in (("w1", w1), ("w2", w2))}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=args.lr)

    def forward(self):
        """The movies' logits, the same on every process."""
        p = self.params
        h = F.relu(self.run(self.ei, self.et, self.x, p["w1"]))
        return self.run(self.ei, self.et, h, p["w2"])[:self.n_m]

    def step(self):
        """One Adam step on the masked cross-entropy; returns the loss."""
        loss = semi_supervised_loss(self.forward(), self.y, self.train_mask)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def test_acc(self):
        with torch.no_grad():
            return float(accuracy(self.forward(), self.y, self.test_mask))


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                    lr=0.005)
    p.add_argument("--ep", type=int, default=0,
                   help="train the expert-parallel tier over this many "
                        "processes (0 = the dense RGCN path)")
    return p


def _say(rank, *args):
    if rank == 0:
        print(*args)


def main_ep(args, data=None, group=None):
    """The expert-parallel loop: ``args.n_epoch`` steps of `ExpertRGCN`,
    test accuracy after every tenth and at the end. Returns {"losses",
    "test_acc", "trainer"}."""
    tr = ExpertRGCN(args, typed_graph() if data is None else data, group)
    losses = []
    for epoch in range(args.n_epoch):
        losses.append(tr.step())
        if epoch % 10 == 0:
            acc = tr.test_acc()  # a collective: every process runs it
            _say(tr.rank, f"[ep={tr.size}] epoch {epoch:3d} loss "
                 f"{losses[-1]:.4f} test {acc:.4f}")
    acc = tr.test_acc()
    _say(tr.rank, f"[ep={tr.size}] final test acc {acc:.4f}")
    return {"losses": losses, "test_acc": acc, "trainer": tr}


def main(args, data=None, params=None):
    """Train; ``args.ep`` picks `main_ep`, else the dense `RGCNModel`
    (``params``: an optional flax-shaped tree for `load_jax_params`).
    Returns what the loop returns (``losses`` among it)."""
    data = typed_graph() if data is None else data
    if getattr(args, "ep", 0):
        return main_ep(args, data)
    resolve_device(args.device)
    torch.manual_seed(args.seed)
    model = RGCNModel(data["x"].shape[1], args.hidden_dim,
                      int(np.asarray(data["y"]).max()) + 1,
                      data["num_relations"], num_bases=2)
    return run_edge_type_trainer(
        model, args, data["x"], data["edge_index"], data["edge_type"],
        data["y"], data["train_mask"], data["test_mask"], params=params)


if __name__ == "__main__":
    from gammagl_tpu_torch.examples.papers100m_trainer import (
        join_launcher_group)
    args = parser().parse_args()
    joined = join_launcher_group(resolve_device(args.device))
    try:
        main(args)
    finally:
        if joined:
            dist.destroy_process_group()
