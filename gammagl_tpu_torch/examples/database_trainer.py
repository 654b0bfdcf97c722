"""Graph-store round trip: a GCN trained from the in-memory feature and
graph stores.

Twin of `examples/database/cora_store.py` (the reference exports Cora into
a Neo4j-style store and trains from it): the node features and labels go
into an `InMemoryFeatureStore` (group ``paper``), the edges into an
`InMemoryGraphStore` as COO (``("paper", "cites", "paper")``), and are
read back; a `GCNModel` (no dropout) trains ``--n_epoch`` steps of Adam
on the masked cross-entropy, then scores the test split. The same flags,
plus ``--device``. COO on every device, as in JAX.

    python -m gammagl_tpu_torch.examples.database_trainer              # the card
    python -m gammagl_tpu_torch.examples.database_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.data.feature_store import InMemoryFeatureStore
from gammagl_tpu_torch.data.graph_store import EdgeLayout, InMemoryGraphStore
from gammagl_tpu_torch.examples.common import base_parser, node_data, predict
from gammagl_tpu_torch.models import GCNModel
from gammagl_tpu_torch.train import (TrainState, accuracy,
                                     semi_supervised_loss)
from gammagl_tpu_torch.utils import load_jax_params, resolve_device

__all__ = ["parser", "main", "round_trip"]

EDGE = ("paper", "cites", "paper")


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=16, n_epoch=50,
                       lr=0.01)


def round_trip(data):
    """Export ``data`` (`node_arrays`) into the two stores and read it
    back: (x, y, edge_index) as the stores return them."""
    n = data["x"].shape[0]
    fstore = InMemoryFeatureStore()
    fstore.put_tensor(np.asarray(data["x"]), group_name="paper",
                      attr_name="x")
    fstore.put_tensor(np.asarray(data["y"]), group_name="paper",
                      attr_name="y")
    gstore = InMemoryGraphStore()
    gstore.put_edge_index(np.asarray(data["edge_index"]), edge_type=EDGE,
                          layout=EdgeLayout.COO, size=(n, n))
    return (fstore.get_tensor("paper", "x"), fstore.get_tensor("paper", "y"),
            gstore.get_edge_index(EDGE, layout=EdgeLayout.COO))


def main(args, data=None, params=None):
    """Train; returns {"losses", "test_acc", "state"}. ``data`` as in
    `common.run_simple_node_trainer`; ``params`` a flax tree of the GCN
    (None: its own init)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    x, y, ei = (torch.as_tensor(np.asarray(a)).to(dev)
                for a in round_trip(data))
    x = x.float()
    n = x.shape[0]
    train_mask, test_mask = (torch.from_numpy(
        np.asarray(data[k]).reshape(n, -1)[:, 0]).to(dev)
        for k in ("train_mask", "test_mask"))
    torch.manual_seed(args.seed)
    model = GCNModel(hidden_dim=args.hidden_dim,
                     num_class=int(np.asarray(data["y"]).max()) + 1,
                     drop_rate=0.0)
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    losses = []
    for _ in range(args.n_epoch):
        model.train()
        loss = semi_supervised_loss(model(x, ei), y, train_mask)
        loss.backward()
        state.apply_gradients()
        losses.append(float(loss.detach()))
    acc = float(accuracy(predict(model, x, ei), y, test_mask))
    print(f"store-roundtrip GCN test acc {acc:.4f} ({dev})")
    return {"losses": losses, "test_acc": acc, "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
