"""Plain float32 reference of gcn-papers100m-1pct's training steps.

GCN (Kipf and Welling 2017): h_{i+1} = act(Â h_i W_i + b_i), ReLU between
layers and none after the last, Â = D^-1/2 (A + I) D^-1/2 with D the
in-degree of A + I (GammaGL's `calc_gcn_norm`, which the port follows);
the loss is the mean softmax cross-entropy over the step's masked rows;
AdamW (`torch.optim.AdamW`, float32) updates the weights. Autograd gives
the gradients. It imports nothing of the port and takes only what the
benchmark made from the seed: edges, features, labels, masks, weights.

``rnd`` rounds every operand of an aggregation or a product, and the
logits, to a lower precision: `harness.compare.fp8` makes this the
control; the identity keeps float32. TF32 is off.
"""

import torch
import torch.nn.functional as F

# edges aggregated at a time: bounds the gathered rows to ~2 GB at F=256
_BLOCK = 1 << 21


def normalized_edges(src, dst, n):
    loops = torch.arange(n, device=src.device)
    s, d = torch.cat([src, loops]), torch.cat([dst, loops])
    deg = torch.bincount(d, minlength=n).double()
    dis = deg.pow(-0.5)
    return s, d, (dis[s] * dis[d]).float()


def _scatter(x, frm, to, w, n):
    out = torch.zeros(n, x.shape[1], device=x.device, dtype=torch.float32)
    for i in range(0, frm.shape[0], _BLOCK):
        sl = slice(i, i + _BLOCK)
        out.index_add_(0, to[sl], x[frm[sl]] * w[sl, None])
    return out


class _Aggregate(torch.autograd.Function):
    """out = Â rnd(x); its gradient Â^T rnd(g)."""

    @staticmethod
    def forward(ctx, x, s, d, w, rnd):
        ctx.graph, ctx.rnd = (s, d, w), rnd
        return _scatter(rnd(x), s, d, w, x.shape[0])

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        s, d, w = ctx.graph
        return _scatter(ctx.rnd(g), d, s, w, g.shape[0]), None, None, None, \
            None


class _Product(torch.autograd.Function):
    """rnd(a) @ rnd(W), its gradients from rounded operands too."""

    @staticmethod
    def forward(ctx, a, w, rnd):
        a, w = rnd(a), rnd(w)
        ctx.save_for_backward(a, w)
        ctx.rnd = rnd
        return a @ w

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = ctx.rnd(g)
        da = g @ w.t() if ctx.needs_input_grad[0] else None
        return da, a.t() @ g, None


def train(cfg, inputs, steps, rnd=lambda t: t):
    """``steps`` AdamW steps from ``inputs['weights']`` on step masks 0..
    steps-1. Returns {"losses", "grads" (the first step's), "delta"
    (weights after the steps minus before)}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = inputs["x"].float()
    n, L = x.shape[0], cfg["num_layers"]
    s, d, w = normalized_edges(inputs["src"], inputs["dst"], n)
    params = {k: v.detach().clone().float().requires_grad_()
              for k, v in inputs["weights"].items()}
    init = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=cfg["learning_rate"],
                            betas=tuple(cfg["adam_betas"]),
                            eps=cfg["adam_eps"],
                            weight_decay=cfg["weight_decay"])
    y = inputs["y"].long()
    losses, first = [], None
    for step in range(steps):
        m = inputs["masks"][step % len(inputs["masks"])].float()
        h = x
        for i in range(L):
            a = _Aggregate.apply(h, s, d, w, rnd)
            h = _Product.apply(a, params[f"w{i}"], rnd) + params[f"b{i}"]
            if i < L - 1:
                h = torch.relu(h)
        ls = F.cross_entropy(rnd(h), y, reduction="none")
        loss = (ls * m).sum() / m.sum().clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        losses.append(loss.item())
        del h, a, ls, loss
    delta = {k: params[k].detach() - init[k] for k in params}
    return {"losses": losses, "grads": first, "delta": delta}
