"""GCN model, counterpart of `gammagl_tpu/models/gcn.py`."""

from torch import nn

from gammagl_tpu_torch.layers.conv import GCNConv

__all__ = ["GCNModel"]


class GCNModel(nn.Module):
    """``num_layers`` GCNConvs with ReLU and dropout between them (Kipf &
    Welling). The first layer's in-features come from the first input or
    from `load_jax_params`, as flax infers them. ``dtype`` is the compute
    dtype; parameters stay float32. Dropout is active in training mode
    only (``model.eval()`` turns it off). ``plan`` is any plan of `Graph`:
    `csr_plan()` or `auto_plan()`'s."""

    def __init__(self, hidden_dim=16, num_class=7, drop_rate=0.5,
                 num_layers=2, norm="both", dtype=None):
        super().__init__()
        dims = [None] + [hidden_dim] * (num_layers - 1) + [num_class]
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], norm=norm, dtype=dtype)
            for i in range(num_layers))
        self.drop = nn.Dropout(drop_rate)
        self.act = nn.ReLU()

    def flax_tree(self):
        return {f"GCNConv_{i}": conv for i, conv in enumerate(self.convs)}

    def forward(self, x, edge_index, edge_weight=None, num_nodes=None,
                plan=None):
        for conv in self.convs[:-1]:
            x = self.drop(self.act(conv(x, edge_index, edge_weight,
                                        num_nodes, plan=plan)))
        return self.convs[-1](x, edge_index, edge_weight, num_nodes,
                              plan=plan)
