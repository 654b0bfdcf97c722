"""UniFews trainer: a GCN whose small edge weights are pruned to exact
no-ops, then its small parameters pruned after training.

Twin of `examples/unifews/unifews_trainer.py`: the same model
(`GCNUniFews`, ``--hidden_dim``, edges below ``--edge_thr`` pruned), the
same loop (``--n_epoch`` steps of Adam at ``--lr`` on the masked
cross-entropy), the same pruning pass (`prune_params` at
``--weight_thr`` on the trained parameters, the test accuracy of the
pruned model, `sparsity` of the masks), the same CSV row
(`UniFewsLogger` under ``<temporary directory>/unifews_log``; the JAX
script writes under ``/tmp/unifews_log``) and the same flags, plus
``--device``. The model takes no plan, as in JAX: its sums are the
port's COO ops on every device.

    python -m gammagl_tpu_torch.examples.unifews_trainer              # the card
    python -m gammagl_tpu_torch.examples.unifews_trainer --device cpu
"""

import copy
import os.path as osp
import tempfile

from gammagl_tpu_torch.examples.common import (base_parser, device_graph,
                                               node_data, predict)
from gammagl_tpu_torch.models import GCNUniFews
from gammagl_tpu_torch.train import TrainState, accuracy, semi_supervised_loss
from gammagl_tpu_torch.utils import (Stopwatch, UniFewsLogger,
                                     load_jax_params, prune_params,
                                     resolve_device, sparsity)

__all__ = ["parser", "main"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=40,
                       lr=0.01, edge_thr=0.05, weight_thr=0.01)


def main(args, data=None, params=None, log_dir=None):
    """Train and prune; returns {"losses", "test_acc", "sparsity",
    "state"}. ``data`` and ``params`` as in `run_simple_node_trainer`;
    ``log_dir``: the logger's base directory (None: ``unifews_log`` in
    the temporary directory)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    d = device_graph(data, dev)
    x, ei = d["x"], d["edge_index"]
    model = GCNUniFews(num_class=int(d["y"].max()) + 1,
                       hidden_dim=args.hidden_dim, edge_thr=args.edge_thr,
                       in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    logger = UniFewsLogger(args.dataset, "gcn_unifews", dir_base=(
        log_dir or osp.join(tempfile.gettempdir(), "unifews_log")))
    losses = []
    sw = Stopwatch()
    sw.start()
    for _ in range(args.n_epoch):
        model.train()
        loss = semi_supervised_loss(model(x, ei), d["y"], d["train_mask"])
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
    t_train = sw.pause()
    pruned, masks = prune_params(model.state_dict(), args.weight_thr)
    pruned_model = copy.deepcopy(model)
    pruned_model.load_state_dict(pruned)
    acc = float(accuracy(predict(pruned_model, x, ei), d["y"],
                         d["test_mask"]))
    sp = sparsity(masks)
    hs, cs = logger.str_csv(args.dataset, "gcn_unifews", args.seed,
                            args.edge_thr, args.weight_thr, acc,
                            args.n_epoch, args.n_epoch, t_train, 0.0, 0.0,
                            0.0, 1.0, sp)
    logger.print_header(hs, cs)
    print(f"test acc {acc:.4f} (weight sparsity {sp:.2%}, {dev})")
    return {"losses": losses, "test_acc": acc, "sparsity": sp,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
