"""Each plain reference against a brute-force dense computation at a tiny
size, and the references' imports."""

import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

import run


def _module(cell_name, what):
    return run.Cell(run.ROOT, cell_name).module(what)


def _gcn_inputs(n=9, e=30, f=5, c=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (e,), generator=g)
    dst = torch.randint(0, n, (e,), generator=g)
    x = torch.randn(n, f, generator=g)
    y = torch.randint(0, c, (n,), generator=g)
    masks = [(torch.rand(n, generator=g) < 0.6).float() for _ in range(3)]
    dims = [f, 6, 6, c]
    weights = {}
    for i in range(3):
        weights[f"w{i}"] = torch.randn(dims[i], dims[i + 1], generator=g)
        weights[f"b{i}"] = torch.randn(dims[i + 1], generator=g) * 0.1
    return {"src": src, "dst": dst, "x": x, "y": y, "masks": masks,
            "weights": weights}


def _dense_gcn_train(cfg, inp, steps):
    n = inp["x"].shape[0]
    A = torch.zeros(n, n, dtype=torch.float64)
    for s, d in zip(inp["src"].tolist() + list(range(n)),
                    inp["dst"].tolist() + list(range(n))):
        A[d, s] += 1
    deg = A.sum(1)
    A = A / torch.sqrt(deg[:, None] * deg[None, :])
    p = {k: v.double().clone().requires_grad_() for k, v in
         inp["weights"].items()}
    init = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = cfg["adam_betas"]
    losses, first = [], None
    for t in range(1, steps + 1):
        h = inp["x"].double()
        for i in range(3):
            h = A @ h @ p[f"w{i}"] + p[f"b{i}"]
            if i < 2:
                h = torch.relu(h)
        mask = inp["masks"][t - 1].double()
        ls = F.cross_entropy(h, inp["y"], reduction="none")
        loss = (ls * mask).sum() / mask.sum()
        grads = torch.autograd.grad(loss, list(p.values()))
        g = dict(zip(p, grads))
        if first is None:
            first = g
        with torch.no_grad():
            for k in p:
                m[k] = b1 * m[k] + (1 - b1) * g[k]
                v2[k] = b2 * v2[k] + (1 - b2) * g[k] ** 2
                mh = m[k] / (1 - b1 ** t)
                vh = v2[k] / (1 - b2 ** t)
                p[k] -= cfg["learning_rate"] * mh / (vh.sqrt()
                                                     + cfg["adam_eps"])
        losses.append(loss.item())
    return {"losses": losses, "grads": first,
            "delta": {k: p[k].detach() - init[k] for k in p}}


def test_gcn_reference_against_dense():
    ref = _module("gcn-papers100m-1pct.train", "reference")
    cfg = run.Cell(run.ROOT, "gcn-papers100m-1pct.train").cfg
    inp = _gcn_inputs()
    got = ref.train(cfg, inp, 3)
    want = _dense_gcn_train(cfg, inp, 3)
    for a, b in zip(got["losses"], want["losses"]):
        assert math.isclose(a, b, rel_tol=1e-5)
    for part in ("grads", "delta"):
        for k in want[part]:
            torch.testing.assert_close(got[part][k].double(), want[part][k],
                                       rtol=1e-4, atol=1e-6)


def _hgt_inputs(cfg, seed=0):
    from graphs.mag import RELATIONS
    model = _module("hgt-ogbn-mag.serve", "model")
    g = torch.Generator().manual_seed(seed)
    counts = {"paper": 7, "author": 5}
    edges = {}
    for rel in RELATIONS:
        ns, nd = counts[rel[0]], counts[rel[2]]
        pairs = torch.randperm(ns * nd, generator=g)[:12]
        edges[rel] = (pairs // nd, pairs % nd)
    small = dict(cfg, heads=2, head_dim=4, hidden_dim=8, feat_dim=3,
                 num_classes=5)
    weights = model.make_weights(small, seed, torch.device("cpu"))
    for k in weights:  # biases, priors and skips away from their defaults
        if weights[k].dim() < 2:
            weights[k] = weights[k] + 0.1 * torch.randn(weights[k].shape,
                                                        generator=g)
    x_author = torch.randn(5, 3, generator=g)
    return small, {"edges": edges, "counts": counts, "x_author": x_author,
                   "weights": weights}, torch.randn(7, 3, generator=g)


def _dense_hgt(cfg, inp, x_paper, W=None, keeps=None):
    """Dense logits; ``keeps`` [(layer, relation) -> (E, H) keep weights
    in edge order] applies attention dropout."""
    if W is None:
        W = {k: v.double() for k, v in inp["weights"].items()}
    H, D = cfg["heads"], cfg["head_dim"]
    x = {"paper": x_paper.double(), "author": inp["x_author"].double()}
    h = {nt: torch.relu(x[nt] @ W[f"proj.{nt}.w"].t() + W[f"proj.{nt}.b"])
         for nt in x}
    for i in range(cfg["num_layers"]):
        def lin(role, nt):
            return (h[nt] @ W[f"conv{i}.{role}.{nt}.w"].t()
                    + W[f"conv{i}.{role}.{nt}.b"]).view(-1, H, D)
        sums = {}
        for rel, (src, dst) in inp["edges"].items():
            s, _, d = rel
            r = "__".join(rel)
            k = torch.einsum("nhd,hde->nhe", lin("k", s),
                             W[f"conv{i}.a_rel.{r}"])
            v = torch.einsum("nhd,hde->nhe", lin("v", s),
                             W[f"conv{i}.m_rel.{r}"])
            q = lin("q", d)
            nd, ns = q.shape[0], k.shape[0]
            adj = torch.zeros(nd, ns, dtype=torch.bool)
            adj[dst, src] = True
            out = torch.zeros(nd, H, D, dtype=torch.float64)
            for hh in range(H):
                sc = (q[:, hh] @ k[:, hh].t()) * W[f"conv{i}.pri.{r}"][hh] \
                    / math.sqrt(D)
                sc = sc.masked_fill(~adj, -math.inf)
                a = torch.softmax(sc, 1).nan_to_num(0.0)
                if keeps is not None:
                    drop = torch.zeros(nd, ns, dtype=torch.float64)
                    drop[dst, src] = keeps[(i, rel)][:, hh].double()
                    a = a * drop
                out[:, hh] = a @ v[:, hh]
            sums[d] = sums[d] + out if d in sums else out
        new = {}
        for nt, agg in sums.items():
            agg = F.gelu(agg.reshape(-1, H * D), approximate="tanh")
            agg = agg @ W[f"conv{i}.out.{nt}.w"].t() + W[f"conv{i}.out.{nt}.b"]
            beta = torch.sigmoid(W[f"conv{i}.skip.{nt}"])
            new[nt] = beta * agg + (1 - beta) * h[nt]
        h = {**h, **new}
    return h["paper"] @ W["head.w"].t() + W["head.b"]


def test_hgt_reference_against_dense():
    ref = _module("hgt-ogbn-mag.serve", "reference")
    cfg = run.Cell(run.ROOT, "hgt-ogbn-mag.serve").cfg
    small, inp, x_paper = _hgt_inputs(cfg)
    got = ref.forward(small, inp, x_paper)
    want = _dense_hgt(small, inp, x_paper)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-6)


def test_references_import_nothing_of_the_port():
    """Each reference, loaded alone in a fresh process, brings in no module
    of the port, of JAX or of the JAX package."""
    refs = sorted(os.listdir(os.path.join(run.BENCH_DIR, "reference")))
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {run.BENCH_DIR!r})\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('ref', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    paths = [os.path.join(run.BENCH_DIR, "reference", r) for r in refs
             if r.endswith(".py")]
    assert paths
    out = subprocess.run([sys.executable, "-c", code, *paths],
                         capture_output=True, text=True, check=True,
                         cwd=run.BENCH_DIR)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"gammagl_tpu_torch", "gammagl_tpu", "jax", "jaxlib",
                       "flax"}


def test_hgt_training_reference_against_dense():
    """Three Adam steps with attention dropout: the reference's blocked
    autograd against dense float64 autograd, the masks drawn alike (in
    each relation's destination-sorted order, layer by layer)."""
    from graphs.mag import RELATIONS
    ref = _module("hgt-ogbn-mag-halfedges.train", "reference")
    cfg = run.Cell(run.ROOT, "hgt-ogbn-mag-halfedges.train").cfg
    small, inp, x_paper = _hgt_inputs(cfg, seed=1)
    g = torch.Generator().manual_seed(5)
    inp["x_paper"] = x_paper
    inp["y"] = torch.randint(0, small["num_classes"], (7,), generator=g)
    inp["masks"] = [(torch.rand(7, generator=g) < 0.7).float()
                    for _ in range(3)]
    inp["mask_generator"] = torch.Generator().manual_seed(9)
    got = ref.train(small, inp, 3)

    draws = torch.Generator().manual_seed(9)
    W = {k: v.double().clone().requires_grad_()
         for k, v in inp["weights"].items()}
    init = {k: v.detach().clone() for k, v in W.items()}
    opt = torch.optim.Adam(list(W.values()), lr=small["learning_rate"])
    rate, H = small["attention_dropout"], small["heads"]
    losses, first = [], None
    for step in range(3):
        keeps = {}
        for i in range(small["num_layers"]):
            for rel in RELATIONS:
                dst = inp["edges"][rel][1]
                drawn = (torch.rand((dst.shape[0], H), generator=draws)
                         < 1 - rate).double() / (1 - rate)
                keep = torch.empty_like(drawn)
                keep[torch.argsort(dst, stable=True)] = drawn
                keeps[(i, rel)] = keep
        logits = _dense_hgt(small, inp, x_paper, W, keeps)
        m = inp["masks"][step].double()
        loss = (F.cross_entropy(logits, inp["y"], reduction="none") * m
                ).sum() / m.sum()
        opt.zero_grad()
        loss.backward()
        if first is None:
            first = {k: (v.grad.clone() if v.grad is not None
                         else torch.zeros_like(v)) for k, v in W.items()}
        opt.step()
        losses.append(loss.item())
    for a, b in zip(got["losses"], losses):
        assert math.isclose(a, b, rel_tol=1e-5)
    for k in first:
        torch.testing.assert_close(got["grads"][k].double(), first[k],
                                   rtol=1e-4, atol=1e-6)
    # a leaf with no gradient but rounding (a key's bias under softmax)
    # moves under Adam by that rounding alone: compared leaves only
    from harness.compare import moving_leaves
    moving = moving_leaves(first)
    assert len(moving) < len(first)
    for k in moving:
        torch.testing.assert_close(got["delta"][k].double(),
                                   W[k].detach() - init[k], rtol=1e-3,
                                   atol=1e-6)
