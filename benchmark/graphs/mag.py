"""The paper and author part of ogbn-mag at its published sizes, drawn on
the device from a seed.

The law of the port's HGT phases (`hgt_relation` and `hgt_graph` in the
port's card script), frozen here and scaled to ogbn-mag's counts: a
``writes`` edge joins a uniform author to paper N_paper * u^1.3, so low
paper ids gather most authors; ``rev_writes`` is each ``writes`` edge
reversed; a ``cites`` edge joins a uniform paper to paper
N_paper * u^1.5. Features are N(0, 1); labels uniform over the venues.
"""

import torch

# ogbn-mag (Hu et al. 2020): papers, authors, paper-writes-author edges,
# paper-cites-paper edges, venues
PAPERS, AUTHORS, WRITES, CITES, VENUES = (736_389, 1_134_649, 7_145_660,
                                          5_416_271, 349)

RELATIONS = (("author", "writes", "paper"), ("paper", "rev_writes", "author"),
             ("paper", "cites", "paper"))


def mag_graph(graph_seed, seed, device, scale=1.0, edge_scale=1.0,
              feat_dim=128):
    """({relation: (src, dst) int64}, {type: node count}, author features
    (N_author, F) float32, paper labels (N_paper,) int64) at ``scale`` of
    ogbn-mag's nodes and edges, the edges cut by ``edge_scale`` more: the
    edges from
    the configuration's graph seed, so every run of a cell serves or trains
    on one graph, the features and labels from the run's seed."""
    n_p, n_a = max(int(PAPERS * scale), 8), max(int(AUTHORS * scale), 8)
    n_w = max(int(WRITES * scale * edge_scale), 8)
    n_c = max(int(CITES * scale * edge_scale), 8)
    gen = torch.Generator(device=device).manual_seed(int(graph_seed))
    a = torch.randint(0, n_a, (n_w,), generator=gen, device=device)
    p = (n_p * torch.rand(n_w, generator=gen, device=device,
                          dtype=torch.float64) ** 1.3).long()
    c_src = torch.randint(0, n_p, (n_c,), generator=gen, device=device)
    c_dst = (n_p * torch.rand(n_c, generator=gen, device=device,
                              dtype=torch.float64) ** 1.5).long()
    edges = {RELATIONS[0]: (a, p), RELATIONS[1]: (p, a),
             RELATIONS[2]: (c_src, c_dst)}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x_author = torch.randn(n_a, feat_dim, generator=gen, device=device)
    y = torch.randint(0, VENUES, (n_p,), generator=gen, device=device)
    return edges, {"paper": n_p, "author": n_a}, x_author, y


def paper_features(seed, index, n, feat_dim, device):
    """Request ``index``'s paper features: N(0, 1), from the seed and the
    index alone."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + 7 * int(index) + 11) % (1 << 62))
    return torch.randn(n, feat_dim, generator=gen, device=device)
