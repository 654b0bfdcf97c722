"""GCN trainer: GCNModel through the CSR SpMM kernel, forward and backward.

Twin of `examples/gcn/gcn_trainer.py`: the same model (GCNConvs with
symmetric degree norm, ReLU and dropout), the same full-batch step (Adam
with decayed weights on the masked cross-entropy), best-validation test
accuracy and a checkpoint of the best parameters, and the same flags, plus
``--device``. The model gets the graph's `CSRPlan`, so on the card every
aggregation and its gradient run the SpMM kernel; on the CPU its plain
version.

    python -m gammagl_tpu_torch.examples.gcn_trainer              # the card
    python -m gammagl_tpu_torch.examples.gcn_trainer --device cpu

``--best_model_path`` names the checkpoint file (`train.save_checkpoint`:
step, the best parameters and the optimizer state); without it nothing is
written.
"""

import time

import numpy as np
import torch

from gammagl_tpu_torch.examples.common import (base_parser, node_data,
                                               run_simple_node_trainer)
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.train import save_checkpoint

__all__ = ["parser", "main"]


def parser():
    p = base_parser(__doc__.splitlines()[0])
    p.add_argument("--best_model_path", default=None)
    return p


def main(args, data=None, params=None):
    """Train; returns what `run_simple_node_trainer` returns. ``data`` and
    ``params`` as there."""
    data = node_data(args, data)
    torch.manual_seed(args.seed)
    model = GCNModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     drop_rate=args.drop_rate)
    t0 = time.time()
    out = run_simple_node_trainer(model, args, data=data, params=params,
                                  log_every=10)
    dt = time.time() - t0
    if args.best_model_path:
        state = out["state"]
        state.model.load_state_dict(out["best_params"])
        save_checkpoint(args.best_model_path, state)
    print(f"done in {dt:.1f}s ({args.n_epoch / dt:.1f} epochs/s)")
    return out


if __name__ == "__main__":
    main(parser().parse_args())
