"""Plain float32 reference of hgt-ogbn-mag's forward.

HGT (Hu et al. 2020), as GammaGL's HGTConv states it: every type's
features projected to the hidden width (linear, ReLU); then per layer,
per node type, k, q and v linear maps split into H heads of D; per
relation (s, r, d) and head, k_rel = k_s a_rel and v_rel = v_s m_rel
(D x D each), a score <q_d[dst], k_rel[src]> pri_rel / sqrt(D) per edge,
its softmax over the edges into each destination, and the softmax-weighted
sum of v_rel[src]; the relations into a type summed, GELU (tanh form), a
linear map, and the skip blend sigmoid(skip) out + (1 - sigmoid(skip)) h;
last a linear map of the papers to the classes. Types that receive no
relation keep their features.

It imports nothing of the port and reads only what the benchmark made:
the edges, the features and the weights in the benchmark's names.
``rnd`` rounds every operand of a product and the attention's q, k and v
to a lower precision (`harness.compare.fp8` makes the control); the
identity keeps float32. TF32 is off.
"""

import math

import torch
import torch.nn.functional as F

# edges a block: bounds a gathered block to ~2 GB at 256 float32 columns
_BLOCK = 1 << 21


class _Product(torch.autograd.Function):
    """rnd(x) @ rnd(w).t(), its gradients from rounded operands too; only
    the rounded operands are kept for the backward."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        x, w = rnd(x), rnd(w)
        ctx.save_for_backward(x, w)
        ctx.rnd = rnd
        return x @ w.t()

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = ctx.rnd(g)
        dx = g @ w if ctx.needs_input_grad[0] else None
        return dx, g.t() @ x, None


class _HeadProduct(torch.autograd.Function):
    """Per head, rnd(x) (N, H, D) times rnd(w) (H, D, E) -> (N, H, E)."""

    @staticmethod
    def forward(ctx, x, w, rnd):
        x, w = rnd(x), rnd(w)
        ctx.save_for_backward(x, w)
        ctx.rnd = rnd
        return torch.einsum("nhd,hde->nhe", x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = ctx.rnd(g)
        return (torch.einsum("nhe,hde->nhd", g, w),
                torch.einsum("nhd,nhe->hde", x, g), None)


def _linear(x, w, b, rnd):
    return _Product.apply(x, w, rnd) + b


class _EdgeDot(torch.autograd.Function):
    """score[e, h] = <q[dst_e, h], k[src_e, h]>, in blocks of edges."""

    @staticmethod
    def forward(ctx, q, k, src, dst, rnd):
        q, k = rnd(q), rnd(k)
        ctx.save_for_backward(q, k)
        ctx.edges, ctx.rnd = (src, dst), rnd
        E = src.shape[0]
        score = torch.empty(E, q.shape[1], device=q.device)
        for i in range(0, E, _BLOCK):
            sl = slice(i, i + _BLOCK)
            score[sl] = (q[dst[sl]] * k[src[sl]]).sum(-1)
        return score

    @staticmethod
    def backward(ctx, g):
        q, k = ctx.saved_tensors
        src, dst = ctx.edges
        g = ctx.rnd(g)
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        for i in range(0, src.shape[0], _BLOCK):
            sl = slice(i, i + _BLOCK)
            ge = g[sl, :, None]
            dq.index_add_(0, dst[sl], ge * k[src[sl]])
            dk.index_add_(0, src[sl], ge * q[dst[sl]])
        return dq, dk, None, None, None


class _WeightedSum(torch.autograd.Function):
    """out[d, h] = sum over edges into d of alpha[e, h] v[src_e, h]."""

    @staticmethod
    def forward(ctx, alpha, v, src, dst, n_dst, rnd):
        v = rnd(v)
        ctx.save_for_backward(alpha, v)
        ctx.edges, ctx.rnd = (src, dst), rnd
        out = torch.zeros(n_dst, v.shape[1], v.shape[2], device=v.device)
        for i in range(0, src.shape[0], _BLOCK):
            sl = slice(i, i + _BLOCK)
            out.index_add_(0, dst[sl], v[src[sl]] * alpha[sl, :, None])
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, v = ctx.saved_tensors
        src, dst = ctx.edges
        g = ctx.rnd(g)
        dalpha, dv = torch.empty_like(alpha), torch.zeros_like(v)
        for i in range(0, src.shape[0], _BLOCK):
            sl = slice(i, i + _BLOCK)
            gd = g[dst[sl]]
            dalpha[sl] = (gd * v[src[sl]]).sum(-1)
            dv.index_add_(0, src[sl], gd * alpha[sl, :, None])
        return dalpha, dv, None, None, None, None


def attention(q, k, v, src, dst, pri, n_dst, rnd, keep=None):
    """One relation: q (N_dst, H, D), k and v (N_src, H, D), edges
    src -> dst; ``keep`` (E, H), in edge order, scales the softmax's
    weights (attention dropout). Returns (N_dst, H, D)."""
    H, D = q.shape[1], q.shape[2]
    E = src.shape[0]
    score = _EdgeDot.apply(q, k, src, dst, rnd) * pri / math.sqrt(D)
    top = torch.full((n_dst, H), -math.inf, device=q.device)
    top.scatter_reduce_(0, dst[:, None].expand(E, H), score.detach(), "amax")
    p = torch.exp(score - top[dst])
    total = torch.zeros(n_dst, H, device=q.device).index_add(0, dst, p)
    alpha = p / total[dst]
    if keep is not None:
        alpha = alpha * keep
    return _WeightedSum.apply(alpha, v, src, dst, n_dst, rnd)


def dropout_keep(generator, rate, heads, dst):
    """The keep weights of one relation's attention dropout, {0, 1/(1 -
    rate)}, drawn from ``generator`` in CSR order (edges stably sorted by
    destination) and returned in edge order."""
    E = dst.shape[0]
    drawn = (torch.rand((E, heads), generator=generator, device=dst.device)
             < 1.0 - rate).float() / (1.0 - rate)
    keep = torch.empty_like(drawn)
    keep[torch.argsort(dst, stable=True)] = drawn
    return keep


def forward(cfg, inputs, x_paper, rnd=lambda t: t, weights=None,
            generator=None):
    """Logits (N_paper, C) of one request's paper features. ``weights``
    (default: the inputs') may require gradients; ``generator`` draws the
    attention dropout masks (training)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    W = inputs["weights"] if weights is None else weights
    H, D = cfg["heads"], cfg["head_dim"]
    x = {"paper": x_paper.float(), "author": inputs["x_author"].float()}
    h = {nt: torch.relu(_linear(x[nt], W[f"proj.{nt}.w"],
                                W[f"proj.{nt}.b"], rnd)) for nt in x}
    for i in range(cfg["num_layers"]):
        kqv = {role: {nt: _linear(h[nt], W[f"conv{i}.{role}.{nt}.w"],
                                  W[f"conv{i}.{role}.{nt}.b"], rnd)
                      .view(-1, H, D) for nt in h}
               for role in ("k", "q", "v")}
        sums = {}
        for rel, (src, dst) in inputs["edges"].items():
            s, _, d = rel
            r = "__".join(rel)
            k = _HeadProduct.apply(kqv["k"][s], W[f"conv{i}.a_rel.{r}"], rnd)
            v = _HeadProduct.apply(kqv["v"][s], W[f"conv{i}.m_rel.{r}"], rnd)
            keep = (None if generator is None else dropout_keep(
                generator, cfg["attention_dropout"], H, dst))
            out = attention(kqv["q"][d], k, v, src, dst,
                            W[f"conv{i}.pri.{r}"], h[d].shape[0], rnd, keep)
            sums[d] = sums[d] + out if d in sums else out
        new = {}
        for nt, agg in sums.items():
            agg = F.gelu(agg.reshape(agg.shape[0], H * D), approximate="tanh")
            agg = _linear(agg, W[f"conv{i}.out.{nt}.w"],
                          W[f"conv{i}.out.{nt}.b"], rnd)
            beta = torch.sigmoid(W[f"conv{i}.skip.{nt}"])
            new[nt] = beta * agg + (1 - beta) * h[nt]
        h = {**h, **new}
    return _linear(h["paper"], W["head.w"], W["head.b"], rnd)


def train(cfg, inputs, steps, rnd=lambda t: t):
    """``steps`` Adam steps (`torch.optim.Adam`, float32) from the inputs'
    weights, with attention dropout drawn from ``inputs['mask_generator']``,
    on step masks 0.. steps-1. Returns {"losses", "grads" (the first
    step's, zero where a leaf gets none), "delta"}."""
    params = {k: v.detach().clone().float().requires_grad_()
              for k, v in inputs["weights"].items()}
    init = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=cfg["learning_rate"])
    y = inputs["y"].long()
    losses, first = [], None
    for step in range(steps):
        m = inputs["masks"][step % len(inputs["masks"])].float()
        logits = forward(cfg, inputs, inputs["x_paper"], rnd, params,
                         inputs["mask_generator"])
        ls = F.cross_entropy(rnd(logits), y, reduction="none")
        loss = (ls * m).sum() / m.sum().clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if first is None:
            first = {k: (p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p)) for k, p in params.items()}
        opt.step()
        losses.append(loss.item())
        del logits, ls, loss
    delta = {k: params[k].detach() - init[k] for k in params}
    return {"losses": losses, "grads": first, "delta": delta}
