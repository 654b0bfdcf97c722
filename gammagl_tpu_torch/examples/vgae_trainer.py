"""VGAE trainer: link prediction with a variational graph autoencoder.

Twin of `examples/vgae/vgae_trainer.py`: the same split (`RandomLinkSplit`
with 5% validation and 10% test edges, directed, seeded ``--seed``), the
same model (`VGAEModel`, hidden ``--hidden_dim``, latent 16), the same
negatives (drawn once by `negative_sampling` from
``np.random.default_rng(--seed)``, as many as the training edges), the
same loop (Adam at ``--lr`` on the reconstruction loss plus the KL term
over the number of nodes; the reparameterisation noise drawn each step
from a generator on the device seeded ``--seed`` + 1) and the AUC of the
mean embeddings on the test edges; the same flags, plus ``--device``.
The encoder takes no plan, as in JAX: its sums are the port's COO ops on
every device.

    python -m gammagl_tpu_torch.examples.vgae_trainer              # the card
    python -m gammagl_tpu_torch.examples.vgae_trainer --device cpu
"""

import numpy as np
import torch

from gammagl_tpu_torch.data import Graph
from gammagl_tpu_torch.examples.common import base_parser, node_data
from gammagl_tpu_torch.models import (VGAEModel, inner_product_decoder,
                                      recon_loss)
from gammagl_tpu_torch.train import TrainState
from gammagl_tpu_torch.transforms import RandomLinkSplit
from gammagl_tpu_torch.utils import (load_jax_params, negative_sampling,
                                     resolve_device)

__all__ = ["parser", "main", "auc_score", "link_split"]


def parser():
    return base_parser(__doc__.splitlines()[0], hidden_dim=32, n_epoch=200,
                       lr=0.01)


def auc_score(pos_scores, neg_scores):
    """ROC AUC of positive against negative scores, by ranks (the JAX
    script's)."""
    scores = np.concatenate([pos_scores, neg_scores])
    labels = np.concatenate([np.ones(len(pos_scores)),
                             np.zeros(len(neg_scores))])
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    n_pos, n_neg = len(pos_scores), len(neg_scores)
    return (ranks[labels == 1].sum() - n_pos * (n_pos + 1) / 2) / (
        n_pos * n_neg)


def link_split(data, seed):
    """(train, val, test) graphs of the JAX script's `RandomLinkSplit`,
    and the negatives drawn once for training: numpy arrays."""
    graph = Graph(x=np.asarray(data["x"]),
                  edge_index=np.asarray(data["edge_index"]))
    train_g, val_g, test_g = RandomLinkSplit(
        num_val=0.05, num_test=0.1, is_undirected=False, seed=seed)(graph)
    tei = np.asarray(train_g.edge_index)
    neg = negative_sampling(tei, num_nodes=graph.num_nodes,
                            num_neg_samples=tei.shape[1],
                            rng=np.random.default_rng(seed))
    return train_g, val_g, test_g, neg


def main(args, data=None, params=None, draws=None):
    """Train and score; returns {"losses", "auc", "state"}. ``data`` and
    ``params`` as in `run_simple_node_trainer`; ``draws``: an iterator of
    the reparameterisation noise, one (N, 16) array a step (None: drawn
    on the device)."""
    dev = resolve_device(args.device)
    data = node_data(args, data)
    train_g, _, test_g, neg = link_split(data, args.seed)
    x = torch.from_numpy(np.asarray(data["x"], np.float32)).to(dev)
    ei = torch.from_numpy(np.asarray(train_g.edge_index)).to(dev)
    neg = torch.from_numpy(neg).to(dev)
    n = x.shape[0]
    torch.manual_seed(args.seed)
    model = VGAEModel(hidden_dim=args.hidden_dim, latent_dim=16,
                      in_channels=x.shape[1])
    if params is not None:
        load_jax_params(model, params)
    state = TrainState(model.to(dev), args.lr)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    losses = []
    for epoch in range(args.n_epoch):
        model.train()
        noise = None if draws is None else torch.as_tensor(next(draws))
        mu, logstd, z = model(x, ei, generator=gen, noise=noise)
        loss = recon_loss(z, ei, neg) + (1.0 / n) * VGAEModel.kl_loss(
            mu, logstd)
        loss.backward()
        state.apply_gradients()
        losses.append(loss.detach())
        if epoch % 20 == 0:
            print(f"epoch {epoch:4d} loss {float(losses[-1]):.4f}")
    model.eval()
    with torch.no_grad():
        mu = model(x, ei)[0]
        label_index = np.asarray(test_g.edge_label_index)
        label = np.asarray(test_g.edge_label)
        pos_s, neg_s = (inner_product_decoder(
            mu, torch.from_numpy(label_index[:, label == v]).to(dev))
            .cpu().numpy() for v in (1, 0))
    auc = auc_score(pos_s, neg_s)
    print(f"test AUC {auc:.4f} ({dev})")
    return {"losses": [float(v) for v in losses], "auc": auc,
            "state": state}


if __name__ == "__main__":
    main(parser().parse_args())
