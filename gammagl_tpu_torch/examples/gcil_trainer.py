"""GCIL trainer: two-view pretraining on an invariance and
decorrelation objective, then a linear probe on the frozen embeddings.

Twin of `examples/gcil/gcil_trainer.py`: the same model (`GCILModel`,
``--hidden_dim``), the same flags (the four ``--drop_*_rate_*`` and
``--real_structure``), plus ``--device``, and the same two routes:

* with ``--real_structure 1`` and the reference checkout's perturbed
  Planetoid adjacencies (``examples/gcil/dataset/<name>/0.01_1_*.npz``
  under ``GGL_REFERENCE_ROOT``; the JAX script reads them under
  ``/root/reference``), each step's two views are two of those graphs in
  turn, with a feature mask each (rates ``--drop_feature_rate_{1,2}``),
  on node data derived from the first graph (`structure_node_data`);
* else (no files, the usual case) `examples.common.run_two_view_ssl`
  with every rate 0.2 (ROADMAP C27's swap is moot at equal rates).

The encoder takes no plan, as in JAX: its sums are the port's COO ops on
every device.

    python -m gammagl_tpu_torch.examples.gcil_trainer              # the card
    python -m gammagl_tpu_torch.examples.gcil_trainer --device cpu
"""

import glob
import os
import os.path as osp

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, linear_probe,
                                               load_sparse_npz, node_data,
                                               run_two_view_ssl,
                                               structure_node_data)
from gammagl_tpu_torch.models import GCILModel
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "real_views"]


def parser():
    p = base_parser(__doc__.splitlines()[0], hidden_dim=128, n_epoch=100,
                    lr=0.0005)
    p.add_argument("--drop_edge_rate_1", type=float, default=0.2)
    p.add_argument("--drop_feature_rate_1", type=float, default=0.2)
    p.add_argument("--drop_edge_rate_2", type=float, default=0.2)
    p.add_argument("--drop_feature_rate_2", type=float, default=0.2)
    p.add_argument("--real_structure", type=int, default=1)
    return p


def real_views(name, root=None):
    """(the perturbed adjacencies of ``name`` as edge indexes, the number
    of nodes), or (None, None) with fewer than two non-empty files.
    ``root``: the reference checkout (None: ``GGL_REFERENCE_ROOT``)."""
    root = root or os.environ.get("GGL_REFERENCE_ROOT")
    if not root:
        return None, None
    files = sorted(glob.glob(osp.join(root, "examples", "gcil", "dataset",
                                      name, "0.01_1_*.npz")))
    views, n = [], None
    for f in files:
        ei, fn = load_sparse_npz(f)
        if ei.shape[1] == 0:  # 0.01_1_0.npz is an empty residue file
            continue
        if n is not None and n != fn:
            raise ValueError(f"{f}: {fn} nodes, the others {n}")
        n = fn
        views.append(ei)
    return (views, n) if len(views) >= 2 else (None, None)


def _main_real(args, views, n, params=None):
    dev = resolve_device(args.device)
    x, y, train_mask, _, test_mask = structure_node_data(views[0], n,
                                                         seed=args.seed)
    df1 = getattr(args, "drop_feature_rate_1", 0.2)
    df2 = getattr(args, "drop_feature_rate_2", 0.2)
    x = torch.from_numpy(x).to(dev)
    eis = [torch.from_numpy(v).to(dev) for v in views]
    model = GCILModel(hidden_dim=args.hidden_dim, in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    for epoch in range(args.n_epoch):
        a, b = epoch % len(eis), (epoch + 1) % len(eis)
        xa = x * (torch.rand((1, x.shape[1]), generator=gen, device=dev)
                  > df1)
        xb = x * (torch.rand((1, x.shape[1]), generator=gen, device=dev)
                  > df2)
        wa = torch.ones(eis[a].shape[1], device=dev)
        wb = torch.ones(eis[b].shape[1], device=dev)
        model.train()
        loss = model(xa, eis[a], wa, xb, eis[b], wb)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
        if epoch % 20 == 0 or epoch == args.n_epoch - 1:
            print(f"pretrain {epoch:4d} loss {losses[-1]:.4f}")
    model.eval()
    with torch.no_grad():
        emb = model(x, eis[0], None)
    d = {k: torch.from_numpy(v).to(dev) for k, v in (
        ("y", y), ("train_mask", train_mask), ("test_mask", test_mask))}
    acc = linear_probe(emb, d, int(y.max()) + 1)
    print(f"probe test acc {acc:.4f} (real structure, {len(eis)} "
          f"perturbation views, {dev})")
    return {"losses": losses, "probe_acc": acc, "state": state}


def main(args, data=None, params=None, draws=None):
    """Pretrain and probe; returns {"losses", "probe_acc", "state"}. With
    ``data`` given the real-structure route is not taken; ``data``,
    ``params`` and ``draws`` as in `run_two_view_ssl`."""
    if data is None and getattr(args, "real_structure", 1):
        views, n = real_views(args.dataset)
        if views is not None:
            return _main_real(args, views, n, params)
    data = node_data(args, data)
    model = GCILModel(hidden_dim=args.hidden_dim,
                      in_channels=np.asarray(data["x"]).shape[1])
    return run_two_view_ssl(model, args, drop_rates=(0.2, 0.2, 0.2, 0.2),
                            embed_fn=lambda m, x, ei: m(x, ei, None),
                            data=data, params=params, draws=draws)


if __name__ == "__main__":
    main(parser().parse_args())
