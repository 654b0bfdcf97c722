"""The comparisons that decide ``correct``, and the lower precision that
the control computes in.

Training: each checked step's loss; the norm of the first gradient as the
optimizer holds it; the norm of the parameters' change after the checked
steps. Norms are compared leaf by leaf, as the gap between the program's
norm and the reference's, over the larger of the reference's norm of that
leaf and of the median leaf, and the worst leaf is the number. Leaves
whose reference gradient is under a thousandth of the median leaf's move
by rounding alone and are left out of the change.

Serving: for each answer (a node's class), the gap by which the
reference's logit of the served class lies below the reference's best.
"""

import math

import torch

FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


def fp8(t):
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto the format's largest), back in t's dtype: the
    precision below bfloat16 that a later change would be tempted by."""
    amax = t.detach().abs().max().float()
    if not torch.isfinite(amax) or amax == 0:
        return t
    s = amax / _FP8_MAX
    q = ((t.detach().float() / s).to(FP8).float() * s).to(t.dtype)
    # the value rounded, the gradient passed through: a backward rounds
    # its own operands where the reference asks it to
    return t + (q - t.detach())


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.detach().float()))
            for k, v in tree.items()}


def _median(vals):
    vals = sorted(vals)
    n = len(vals)
    return (vals[n // 2] if n % 2 else
            0.5 * (vals[n // 2 - 1] + vals[n // 2])) if n else 0.0


def norm_gap(got, want, leaves=None):
    """max over leaves of |‖got‖ - ‖want‖| / max(‖want‖, median ‖want‖)
    and the leaf that gives it."""
    gn, wn = _norms(got), _norms(want)
    keys = [k for k in wn if leaves is None or k in leaves]
    floor = _median([wn[k] for k in keys])
    worst, at = 0.0, None
    for k in keys:
        g = gn.get(k, float("nan"))
        gap = abs(g - wn[k]) / max(wn[k], floor, 1e-30)
        if math.isnan(gap):
            return float("inf"), k
        if gap > worst:
            worst, at = gap, k
    return worst, at


def diff_gap(got, want):
    """max over leaves of ‖got - want‖ / max(‖want‖, median ‖want‖): the
    error itself, first order in the rounding, where a gap of norms is
    second order in it."""
    wn = _norms(want)
    floor = _median(list(wn.values()))
    worst = 0.0
    for k, w in want.items():
        g = got.get(k)
        if g is None:
            return float("inf")
        d = float(torch.linalg.vector_norm((g.float() - w.float()).detach()))
        gap = d / max(wn[k], floor, 1e-30)
        if not math.isfinite(gap):
            return float("inf")
        worst = max(worst, gap)
    return worst


def moving_leaves(ref_grads):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    n = _norms(ref_grads)
    floor = 1e-3 * _median(list(n.values()))
    return {k for k, v in n.items() if v >= floor}


def training_numbers(prog, ref):
    """``prog`` and ``ref``: {"losses": [...], "grads": {leaf: tensor},
    "delta": {leaf: tensor}}. Returns the compared numbers and, for the
    norms, the leaf that gave each."""
    loss_gap = 0.0
    for a, b in zip(prog["losses"], ref["losses"]):
        gap = abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
        loss_gap = max(loss_gap, gap if math.isfinite(gap) else math.inf)
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    grad_gap, grad_at = norm_gap(prog["grads"], ref["grads"])
    delta_gap, delta_at = norm_gap(prog["delta"], ref["delta"],
                                   moving_leaves(ref["grads"]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "delta_gap": delta_gap,
            "grad_error": diff_gap(prog["grads"], ref["grads"])}, {
                "grad_gap": grad_at,
                                      "delta_gap": delta_at}


def served_gap(served, ref_logits):
    """The widest gap by which the reference's logit of the served class
    lies below its best, over the rows; inf when a row has no answer or
    an answer out of range."""
    served = served.to(ref_logits.device).long()
    if served.shape != ref_logits.shape[:1]:
        return math.inf
    c = ref_logits.shape[1]
    if bool(((served < 0) | (served >= c)).any()):
        return math.inf
    best = ref_logits.max(1).values
    got = ref_logits.gather(1, served[:, None])[:, 0]
    return float((best - got).max())


def verdict(numbers, limits):
    """(correct, rows): every number at or under its limit; rows are
    (name, value, limit) in the limits' order."""
    rows = [(k, numbers.get(k, math.inf), limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
