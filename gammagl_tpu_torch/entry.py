"""Entry points of the port: a forward on the flagship model, and a dry run
of every parallel tier across processes.

Counterpart of the JAX repo's `__graft_entry__.py`:

* `entry(device=None)` returns ``(fn, example_args)``: the forward of
  ``GCNModel(hidden_dim=16, num_class=7)`` on the Cora-shaped synthetic
  graph, through the CSR SpMM kernel on the card (its plain version on
  the CPU).
* `dryrun_multichip(n_procs, device=None)` starts ``n_procs`` processes in
  one gloo group (on the card they share it, as one host's processes
  share one H100). Each runs every tier of the JAX function, in its
  order, and holds each output and gradient against a one-process dense
  reference with `_check` (the JAX function's definition and
  tolerances). A tier past its tolerance raises in its process, and the
  parent raises when any process failed. Rank 0 prints the JAX
  function's two summary lines.

The JAX function lays the devices of one process out in a mesh; the
port runs one process a device. Its n processes form a dp x tp grid
(`parallel.mesh.grid_world`, tp = 2 when n is even, as the JAX mesh) and
run, in order:

  dp_tp         one GCN step of Adam(1e-2): edges over dp (the sharded
                SpMM, PERF.md row 1), ``w1`` column-sharded and ``w2``
                row-sharded over tp; loss and whole gradients
  halo          the flat halo tier (no kernel: the JAX tier is XLA)
  planned       the planned halo tier (rows 1 and 5)
  attn          the partitioned GAT layer (rows 10, 11 and 1)
  hier, hier_planned   the two-level tiers on a 2 x n/2 grid, at even
                n >= 4 (the second on rows 1 and 5)
  sp, ep, pp    the feature-sharded, expert and pipeline strategies
  mb            a sampled minibatch, one padded shard a process, its
                masked loss summed over the group (row 1)
  hetero_attn   HGT-style attention with relation r owned by rank r: the
                scores and softmax per destination, then `spmm_csr` with
                the softmax as edge weights (row 1; row 8's gathered
                SDDMM for the weights' gradient)

The parent prints the scaling roofline of the JAX function (the arxiv
scale graph's halo partition, `halo_scaling_estimate`) while the
processes run: once with the JAX package's TPU v5e rates, whose figures
the JAX function prints, and once with `HwModel()`'s H100 rates.

    python -m gammagl_tpu_torch.entry                   # the card, 4 procs
    python -m gammagl_tpu_torch.entry --procs 2 --device cpu
"""

import argparse
import contextlib
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from gammagl_tpu_torch.utils.device import resolve_device, to_device

__all__ = ["entry", "dryrun_multichip"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `_check`'s tolerance where the JAX function passes one
TOLS = {"attn_out": 5e-4, "attn_grad_h": 5e-4, "attn_grad_a": 5e-4,
        "ep_grad": 5e-4, "pp_out": 5e-4, "pp_grad": 5e-4,
        "mb_grad_w1": 5e-4, "mb_grad_w2": 5e-4, "hetero_attn_out": 5e-4,
        "hetero_attn_grad_x": 1e-3, "hetero_attn_grad_wk": 1e-3}
# the full-width steps against one process: max |got - want| / max |want|;
# a gradient behind the ReLU at FULL_RELU_TOL when a ReLU input changed
# sign between the two sum orders (ROADMAP C's rule for train phases:
# such a flip moves the gradient by its row's share)
FULL_TOL, FULL_RELU_TOL = 1e-4, 1e-3
BEHIND_RELU = ("dp_tp_grad_w1",)
# the kernels each tier must launch on the card (PERF.md section 6 rows)
KERNELS_BY_TIER = {
    "dp_tp": {"spmm_csr"}, "planned": {"spmm_csr_acc"},
    "attn": {"flash_forward", "flash_backward"},
    "hier_planned": {"spmm_csr_acc"}, "sp": {"spmm_csr"},
    "ep": {"spmm_csr"}, "mb": {"spmm_csr"},
    "hetero_attn": {"spmm_csr", "sddmm_csr"}, "dp-tp": {"spmm_csr"},
    "het-r": {"spmm_csr", "sddmm_csr"}}
# the full-width shapes: bench.py's arxiv-scale graph (GCN at F = 128,
# hidden 256, 40 classes) and bench_hgt's 2M edges as 4 relations
ARXIV = dict(n=169_343, e=2_315_598, f=128, h=256, c=40)
HETERO = dict(n=100_000, d=64, e=500_000)
# the JAX package's `scaling.V5E` (TPU v5e rates), whose roofline figures
# the JAX function prints
_JAX_V5E = dict(hbm_gbps=819.0, ici_gbps=186.0, dcn_gbps=25.0,
                bf16_tflops=197.0, spmm_edges_per_s=180e6)


def _synthetic_graph(n=2708, e=13264, f=1433, c=7, seed=0):
    """Cora-shaped synthetic graph (sizes from the reference kernel-bench
    protocol, profiler/mpops/complete_test/README.md), with self-loops:
    the JAX function's draws."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    ei = np.stack([np.concatenate([src, np.arange(n)]),
                   np.concatenate([dst, np.arange(n)])]).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    return x, ei, y


def entry(device=None):
    """``(fn, example_args)``: ``fn(params, x, edge_index)`` is the forward
    of ``GCNModel(hidden_dim=16, num_class=7)`` in eval mode with
    ``params`` (a dict of the model's parameters, as
    ``torch.func.functional_call`` takes them) on the Cora-shaped graph's
    CSR plan, so on the card its sums launch the CSR SpMM kernel;
    ``example_args`` are the model's own parameters (drawn under
    ``torch.manual_seed(0)``, the global generator left as it was) and the
    graph's x and edge_index, on ``device`` (None: the card)."""
    from gammagl_tpu_torch.data import Graph
    from gammagl_tpu_torch.models import GCNModel
    device = resolve_device(device)
    x, ei, _ = _synthetic_graph()
    plan = Graph(edge_index=ei, num_nodes=x.shape[0]).csr_plan()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = GCNModel(hidden_dim=16, num_class=7).eval()
        with torch.no_grad():  # the lazy first layer takes x's width
            model(torch.from_numpy(x), torch.from_numpy(ei), plan=plan)
    model.to(device)
    params = {name: p.detach() for name, p in model.named_parameters()}

    def fn(params, x, edge_index):
        return torch.func.functional_call(model, params, (x, edge_index),
                                          {"plan": plan})

    return fn, (params, to_device(x, device), to_device(ei, device))


# -- the references and the check, the JAX function's ------------------------

def _ref_spmm(ei, w, x, num_rows):
    """numpy reference: out[dst] += w * x[src]."""
    out = np.zeros((num_rows, x.shape[1]), np.float64)
    np.add.at(out, np.asarray(ei[1]),
              np.asarray(w)[:, None] * np.asarray(x, np.float64)[ei[0]])
    return out.astype(np.float32)


def _ref_gat(ei, h, a_src, a_dst, num_rows, slope=0.2):
    """numpy reference for the partitioned GAT layer (edge softmax per
    destination; reference gammagl/layers/conv/gat_conv.py:7)."""
    heads, fh = a_src.shape
    h3 = np.asarray(h, np.float64).reshape(h.shape[0], heads, fh)
    as_n = np.einsum("lhf,hf->lh", h3, np.asarray(a_src, np.float64))
    ad_n = np.einsum("lhf,hf->lh", h3, np.asarray(a_dst, np.float64))
    src, dst = np.asarray(ei[0]), np.asarray(ei[1])
    e = as_n[src] + ad_n[dst]
    e = np.where(e > 0, e, slope * e)                  # (E, H)
    out = np.zeros((num_rows, heads, fh))
    for hh in range(heads):
        m = np.full(num_rows, -np.inf)
        np.maximum.at(m, dst, e[:, hh])
        m = np.where(np.isfinite(m), m, 0.0)
        ex = np.exp(e[:, hh] - m[dst])
        s = np.zeros(num_rows)
        np.add.at(s, dst, ex)
        alpha = ex / np.maximum(s, 1e-16)[dst]
        np.add.at(out[:, hh, :], dst, alpha[:, None] * h3[src, hh, :])
    return out.reshape(num_rows, heads * fh).astype(np.float32)


def _check(errs, name, got, want, tol=2e-4):
    """The JAX function's check: max |got - want| over max(max |want|, 1)
    below ``tol``, recorded in ``errs``; raises past it."""
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    if isinstance(want, torch.Tensor):
        want = want.detach().cpu().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1.0)
    err = float(np.abs(got - want).max() / scale)
    errs[name] = err
    if not err < tol:
        raise AssertionError(f"{name}: max rel err {err:.3e} (tol {tol:.0e})")
    return err


def _t64(a):
    """A float64 host tensor of an array or tensor, for the references."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double()
    return torch.from_numpy(np.asarray(a, np.float64))


def _agg64(ei, w, h, num_rows):
    """The reference sum out[dst] += w * h[src] in float64 on the host,
    differentiable in h (and w)."""
    src = torch.as_tensor(np.asarray(ei[0]), dtype=torch.long)
    dst = torch.as_tensor(np.asarray(ei[1]), dtype=torch.long)
    return torch.zeros(num_rows, h.shape[1], dtype=h.dtype).index_add(
        0, dst, h[src] * w[:, None])


# -- the tiers ----------------------------------------------------------------

def _size(group=None):
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def _rank():
    return dist.get_rank() if _size() > 1 else 0


def _all_gather(t, dim=0, group=None):
    """Every process's ``t`` (one shape) concatenated along ``dim`` in the
    group's rank order, on the host."""
    t = t.detach().cpu().contiguous()
    size = _size(group)
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def _all_sum(t, group=None):
    """``t`` summed over the group, on the host."""
    t = t.detach().cpu().clone()
    if _size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launch_counts():
    """Each kernel wrapper's launch count (`ops.cuda`: every wrapper
    counts where it launches its kernel; the plain versions count none)."""
    from gammagl_tpu_torch.ops import cuda as k
    return {name: fn.launches for name, fn in vars(k).items()
            if callable(fn) and hasattr(fn, "launches")}


class _Record:
    """Each tier's launches and host ms on this process: `run(label)`
    wraps a tier's forward and backward (the references stay outside)."""

    def __init__(self, device):
        self.device = device
        self.launches, self.ms = {}, {}

    @contextlib.contextmanager
    def run(self, label):
        if _size() > 1:
            dist.barrier()
        _sync(self.device)
        before = _launch_counts()
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.ms[label] = (time.perf_counter() - t0) * 1e3
        after = _launch_counts()
        counts = {k: after[k] - before[k] for k in after
                  if after[k] != before[k]}
        self.launches[label] = counts
        want = KERNELS_BY_TIER.get(label, set())
        if _size() == 1:  # one part: a planned tier's interior sum alone
            want = want - {"spmm_csr_acc"}
        if self.device.type == "cuda" and want - set(counts):
            raise RuntimeError(f"tier {label}: launched {counts}, which "
                               f"lacks {sorted(want - set(counts))}")


def _gcn_case(full):
    """The dp_tp tier's graph, weights and labels: the JAX function's 64
    nodes (``full``: the arxiv-scale graph of bench.py, with self-loops)."""
    from gammagl_tpu_torch.utils.norm import calc_gcn_norm_np
    if full:
        a = ARXIV
        rng = np.random.default_rng(0)
        dst = (a["n"] * (rng.random(a["e"]) ** 1.5)).astype(np.int64)
        src = rng.integers(0, a["n"], a["e"])
        loops = np.arange(a["n"])
        ei = np.stack([np.concatenate([src, loops]),
                       np.concatenate([dst, loops])])
        x = rng.normal(size=(a["n"], a["f"])).astype(np.float32)
        y = rng.integers(0, a["c"], a["n"]).astype(np.int32)
        w1 = (rng.normal(size=(a["f"], a["h"])) * 0.1).astype(np.float32)
        w2 = (rng.normal(size=(a["h"], a["c"])) * 0.1).astype(np.float32)
    else:
        n, f, h, c = 64, 32, 16, 4
        x, ei, y = _synthetic_graph(n=n, e=4 * n, f=f, c=c)
        w1 = (np.random.default_rng(0).normal(size=(f, h)) * 0.1
              ).astype(np.float32)
        w2 = (np.random.default_rng(1).normal(size=(h, c)) * 0.1
              ).astype(np.float32)
    return x, ei, y, calc_gcn_norm_np(ei, x.shape[0]), w1, w2


def dp_tp_step(grid, x, ei, w_norm, y, w1, w2, device, lr=1e-2,
               relu_signs=None):
    """One GCN step of Adam(``lr``) on a `DpTpGrid`: the edges cut into
    ``grid.dp`` uniform shards, each summed by the sharded SpMM over the
    dp group; ``w1`` column-sharded over tp (a column-parallel ``x @ w1``,
    the SpMM and ReLU on this process's columns) and ``w2`` row-sharded
    (``h1 @ w2`` summed over tp), so the logits are those of
    ``A relu(A x w1) w2`` with the loss their mean cross-entropy.

    Returns (loss, dw1, dw2): the gradients whole, gathered over tp on the
    host. The (1, 1) grid is the same step in one process. A list
    ``relu_signs`` gets the ReLU inputs' signs (``> 0``, gathered over
    tp, packed bits on the host)."""
    from gammagl_tpu_torch.parallel import (make_sharded_spmm,
                                            partition_edges_uniform)
    from gammagl_tpu_torch.parallel.spmm import _reduce_from_group
    n = x.shape[0]
    part = partition_edges_uniform(ei, n, grid.dp, w_norm)
    spmm = make_sharded_spmm(n, grid.dp_group)
    ei_s = part.edge_index
    w_s = torch.from_numpy(part.edge_weight).to(device)
    hc = w1.shape[1] // grid.tp
    cols = slice(grid.tp_index * hc, (grid.tp_index + 1) * hc)
    # copies: the step updates them in place
    p1 = to_device(w1[:, cols].copy(), device).requires_grad_()
    p2 = to_device(w2[cols].copy(), device).requires_grad_()
    opt = torch.optim.Adam([p1, p2], lr=lr)
    xd, yd = to_device(x, device), to_device(y, device).long()
    pre = spmm(ei_s, w_s, xd @ p1)
    if relu_signs is not None:
        relu_signs.append(np.packbits(_all_gather(
            pre > 0, 1, grid.tp_group).numpy()))
    h1 = torch.relu(pre)
    z = _reduce_from_group(h1 @ p2, grid.tp_group, grid.tp)
    loss = F.cross_entropy(spmm(ei_s, w_s, z), yd)
    loss.backward()
    dw1 = _all_gather(p1.grad, 1, grid.tp_group)
    dw2 = _all_gather(p2.grad, 0, grid.tp_group)
    opt.step()
    return loss.detach(), dw1, dw2


def _dense_gcn_loss(x, ei, w, y, w1, w2):
    """The reference loss of the dp_tp step, float64 on the host."""
    n = x.shape[0]
    h1 = torch.relu(_agg64(ei, w, x @ w1, n))
    return F.cross_entropy(_agg64(ei, w, h1 @ w2, n),
                           torch.as_tensor(y, dtype=torch.long))


def _tier_dp_tp(errs, rec, grid, device):
    x, ei, y, w_norm, w1, w2 = _gcn_case(False)
    with rec.run("dp_tp"):
        loss, dw1, dw2 = dp_tp_step(grid, x, ei, w_norm, y, w1, w2, device)
    r1, r2 = _t64(w1).requires_grad_(), _t64(w2).requires_grad_()
    ref = _dense_gcn_loss(_t64(x), ei, _t64(w_norm), y, r1, r2)
    ref.backward()
    _check(errs, "dp_tp_loss", loss, ref)
    _check(errs, "dp_tp_grad_w1", dw1, r1.grad)
    _check(errs, "dp_tp_grad_w2", dw2, r2.grad)
    return float(loss)


def _halo_checks(errs, name, rec, spmm, part, x, ei, w_norm, device,
                 grad=True):
    """A halo tier's output (and the gradient of the sum of its squares)
    on this process's block, gathered and held against the numpy sums."""
    from gammagl_tpu_torch.parallel import shard_nodes, unpad_nodes
    n = x.shape[0]
    xb = shard_nodes(x, part, device=device).requires_grad_(grad)
    with rec.run(name):
        out = spmm(xb)
        if grad:
            (out ** 2).sum().backward()
    ref_out = _ref_spmm(ei, w_norm, x, n)
    _check(errs, f"{name}_out", unpad_nodes(_all_gather(out), part), ref_out)
    if grad:
        _check(errs, f"{name}_grad", unpad_nodes(_all_gather(xb.grad), part),
               2.0 * _ref_spmm(ei[::-1], w_norm, ref_out, n))


def _dense_gat(h, a_src, a_dst, ei, rows, slope=0.2):
    """The partitioned GAT layer's function, float64 on the host and
    differentiable (the per-row max is a constant of the softmax)."""
    heads, fh = a_src.shape
    src = torch.as_tensor(np.asarray(ei[0]), dtype=torch.long)
    dst = torch.as_tensor(np.asarray(ei[1]), dtype=torch.long)
    h3 = h.view(-1, heads, fh)
    e = F.leaky_relu((h3 * a_src).sum(-1)[src] + (h3 * a_dst).sum(-1)[dst],
                     slope)
    m = torch.full((rows, heads), -np.inf, dtype=h.dtype).scatter_reduce(
        0, dst[:, None].expand(-1, heads), e.detach(), "amax")
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(e - m[dst])
    s = torch.zeros(rows, heads, dtype=h.dtype).index_add(0, dst, ex)
    alpha = ex / s.clamp_min(1e-16)[dst]
    out = torch.zeros(rows, heads, fh, dtype=h.dtype).index_add(
        0, dst, alpha[..., None] * h3[src])
    return out.reshape(rows, heads * fh)


def _tier_attn(errs, rec, n_procs, x, ei, device):
    from gammagl_tpu_torch.parallel import (build_halo_partition_attn,
                                            make_partitioned_gat_layer)
    n = x.shape[0]
    heads, fh = 2, 8
    part = build_halo_partition_attn(ei, n, n_procs, R=8, ET=128)
    layer = make_partitioned_gat_layer(part, heads)
    total = part.num_parts * part.rows_per
    rng = np.random.default_rng(7)
    ha = np.pad(rng.normal(size=(n, heads * fh)),
                ((0, total - n), (0, 0))).astype(np.float32)
    a_src = rng.normal(size=(heads, fh)).astype(np.float32)
    a_dst = rng.normal(size=(heads, fh)).astype(np.float32)
    rank = _rank()
    rows = slice(rank * part.rows_per, (rank + 1) * part.rows_per)
    hb = to_device(ha[rows], device).requires_grad_()
    asd = to_device(a_src, device).requires_grad_()
    add = to_device(a_dst, device)
    with rec.run("attn"):
        out = layer(hb, asd, add)
        (out ** 2).sum().backward()
    _check(errs, "attn_out", _all_gather(out),
           _ref_gat(ei, ha, a_src, a_dst, total), tol=TOLS["attn_out"])
    rh, ra = _t64(ha).requires_grad_(), _t64(a_src).requires_grad_()
    (_dense_gat(rh, ra, _t64(a_dst), ei, total) ** 2).sum().backward()
    _check(errs, "attn_grad_h", _all_gather(hb.grad), rh.grad,
           tol=TOLS["attn_grad_h"])
    _check(errs, "attn_grad_a", _all_sum(asd.grad), ra.grad,
           tol=TOLS["attn_grad_a"])


def _tier_sp_ep_pp(errs, rec, n_procs, x, ei, w_norm, device):
    from gammagl_tpu_torch.parallel import (make_feature_sharded_spmm,
                                            make_pipeline_apply,
                                            make_relation_expert_spmm,
                                            shard_expert_weights,
                                            shard_pipeline_params)
    n, f = x.shape
    h = 16
    rank = _rank()

    # sp: a block of 8 feature columns a process, no collective
    xs = np.random.default_rng(2).normal(size=(n, n_procs * 8)).astype(
        np.float32)
    run = make_feature_sharded_spmm(n)
    xb = to_device(xs[:, rank * 8:(rank + 1) * 8], device).requires_grad_()
    with rec.run("sp"):
        out = run(ei, w_norm, xb)
        (out ** 2).sum().backward()
    ref = _ref_spmm(ei, w_norm, xs, n)
    _check(errs, "sp_out", _all_gather(out, 1), ref)
    _check(errs, "sp_grad", _all_gather(xb.grad, 1),
           2.0 * _ref_spmm(ei[::-1], w_norm, ref, n))

    # ep: the relation weights as experts, ceil(R / P) a process
    num_rel = n_procs + 1
    et = np.random.default_rng(3).integers(0, num_rel, ei.shape[1])
    W = (np.random.default_rng(4).normal(size=(num_rel, f, h)) * 0.1
         ).astype(np.float32)
    run = make_relation_expert_spmm(n)
    wl = shard_expert_weights(W, device=device).requires_grad_()
    args = (to_device(ei, device), to_device(et, device),
            to_device(x, device))
    with rec.run("ep"):
        out = run(*args, wl)
        (out ** 2).sum().backward()
    xe = x[ei[0]].astype(np.float64)
    ref = np.zeros((n, h))
    np.add.at(ref, ei[1], np.einsum("ef,efo->eo", xe, W[et]))
    _check(errs, "ep_out", out, ref)
    ct = 2.0 * out.detach().cpu().double().numpy()
    gw = np.zeros(W.shape)
    np.add.at(gw, et, np.einsum("ef,eo->efo", xe, ct[ei[1]]))
    _check(errs, "ep_grad", _all_gather(wl.grad)[:num_rel], gw,
           tol=TOLS["ep_grad"])

    # pp: GPipe over n_procs tanh stages, 3 microbatches
    stage_w = (np.random.default_rng(5).normal(size=(n_procs, f, f)) * 0.1
               ).astype(np.float32)
    xm = np.random.default_rng(6).normal(size=(3, 8, f)).astype(np.float32)
    run = make_pipeline_apply(lambda p, hh: torch.tanh(hh @ p), xm.shape[0])
    ps = shard_pipeline_params(stage_w, device=device).requires_grad_()
    with rec.run("pp"):
        out = run(ps, to_device(xm, device))
        (out ** 2).sum().backward()
    sw = _t64(stage_w).requires_grad_()
    hh = _t64(xm)
    for s in range(n_procs):
        hh = torch.tanh(hh @ sw[s])
    _check(errs, "pp_out", out, hh, tol=TOLS["pp_out"])
    (hh ** 2).sum().backward()
    _check(errs, "pp_grad", _all_gather(ps.grad[None]), sw.grad,
           tol=TOLS["pp_grad"])


def _mb_case():
    """The mb tier's graph and weights (the JAX function's draws)."""
    from gammagl_tpu_torch.data import Graph
    rng = np.random.default_rng(11)
    n, f, c = 200, 16, 3
    ei = np.stack([rng.integers(0, n, 1200), rng.integers(0, n, 1200)])
    g = Graph(edge_index=ei.astype(np.int64),
              x=rng.normal(size=(n, f)).astype(np.float32),
              y=rng.integers(0, c, n).astype(np.int32), num_nodes=n)
    w1 = (np.random.default_rng(12).normal(size=(f, 8)) * 0.3).astype(
        np.float32)
    w2 = (np.random.default_rng(13).normal(size=(8, c)) * 0.3).astype(
        np.float32)
    return g, ei, w1, w2


def _mb_batch(g, ei, index, count, device):
    """Shard ``index`` of ``count`` of the first padded batch, as process
    ``index`` of a group of ``count`` samples it (its own sampler, seed 0:
    8 seeds, fanouts [4, 4]); and the loader's node bucket."""
    from gammagl_tpu_torch.loader import MultiHostNodeLoader
    from gammagl_tpu_torch.sampler import NeighborSampler
    sampler = NeighborSampler(ei, g.num_nodes, num_neighbors=[4, 4], seed=0)
    loader = MultiHostNodeLoader(g, sampler, batch_size=8, shuffle=False,
                                 process_index=index, process_count=count,
                                 device=device)
    return {k: v[0] for k, v in next(iter(loader)).items()}, \
        loader.node_bucket


def mb_local_sums(w1, w2, batch, num_rows):
    """One padded shard's (sum of masked losses, count of seeds): two
    layers whose sums run `spmm_csr` with ``edge_mask`` as the edge
    weights on the shard's plan, ReLU between them."""
    from gammagl_tpu_torch.ops.cuda import build_csr_plan, spmm_csr
    ei = batch["edge_index"].cpu().numpy()
    plan = build_csr_plan(ei[0], ei[1], num_rows)
    w = batch["edge_mask"].float()
    h1 = torch.relu(spmm_csr(batch["x"] @ w1, w, plan))
    logits = spmm_csr(h1 @ w2, w, plan)
    ll = F.cross_entropy(logits, batch["y"].long(), reduction="none")
    sm = batch["seed_mask"].float()
    return (ll * sm).sum(), sm.sum()


def mb_loss(w1, w2, batch, num_rows, group=None):
    """The minibatch loss over the group: each process's masked loss and
    seed count summed over it, ``sum(loss) / sum(count)``; the weights
    enter replicated, so their gradients are whole on every process."""
    from gammagl_tpu_torch.parallel.spmm import (_copy_to_group,
                                                 _reduce_from_group)
    size = _size(group)
    w1, w2 = (_copy_to_group(w, group, size) for w in (w1, w2))
    ls, cnt = mb_local_sums(w1, w2, batch, num_rows)
    return _reduce_from_group(ls, group, size) / _all_sum(cnt, group).to(
        ls.device)


def _dense_mb_sums(w1, w2, batch, num_rows):
    """`mb_local_sums` in float64 on the host."""
    ei = batch["edge_index"].cpu().numpy()
    w = _t64(batch["edge_mask"].float())
    h1 = torch.relu(_agg64(ei, w, _t64(batch["x"]) @ w1, num_rows))
    logits = _agg64(ei, w, h1 @ w2, num_rows)
    ll = F.cross_entropy(logits, batch["y"].cpu().long(), reduction="none")
    sm = _t64(batch["seed_mask"].float())
    return (ll * sm).sum(), sm.sum()


def _tier_mb(errs, rec, n_procs, device):
    g, ei, w1, w2 = _mb_case()
    rank = _rank()
    batch, nb = _mb_batch(g, ei, rank, n_procs, device)
    p1 = to_device(w1, device).requires_grad_()
    p2 = to_device(w2, device).requires_grad_()
    with rec.run("mb"):
        loss = mb_loss(p1, p2, batch, nb)
        loss.backward()
    # one process over every shard of the same padded batch
    r1, r2 = _t64(w1).requires_grad_(), _t64(w2).requires_grad_()
    sums = [_dense_mb_sums(r1, r2, _mb_batch(g, ei, i, n_procs, "cpu")[0],
                           nb) for i in range(n_procs)]
    ref = sum(s for s, _ in sums) / sum(float(c) for _, c in sums)
    ref.backward()
    _check(errs, "mb_loss", loss, ref)
    _check(errs, "mb_grad_w1", p1.grad, r1.grad, tol=TOLS["mb_grad_w1"])
    _check(errs, "mb_grad_w2", p2.grad, r2.grad, tol=TOLS["mb_grad_w2"])


def _hetero_case(full, num_rel):
    """``num_rel`` relations' edges, x and the k, q, v weights: the JAX
    function's draws (``full``: `HETERO`'s sizes)."""
    n, d, e = ((HETERO["n"], HETERO["d"], HETERO["e"]) if full
               else (48, 8, 160))
    rng = np.random.default_rng(21)
    rel_ei = [np.stack([rng.integers(0, n, e), rng.integers(0, n, e)])
              for _ in range(num_rel)]
    x = rng.normal(size=(n, d)).astype(np.float32)
    wk, wq, wv = ((rng.normal(size=(num_rel, d, d)) * 0.4).astype(np.float32)
                  for _ in range(3))
    return rel_ei, x, wk, wq, wv


def relation_attention(x, wk, wq, wv, plan):
    """One relation's attention on its `CSRPlan`: keys, queries and values
    of x, the scaled dot score of each edge, the softmax over each
    destination's edges (in the plan's CSR order, a row's edges in one
    run), and the sum of the values weighted by it, `spmm_csr` with the
    softmax as the edge weights: on the card its kernel, and in the
    backward its transpose and the gathered SDDMM for the weights."""
    from gammagl_tpu_torch.ops.cuda import spmm_csr
    rowptr, col, _ = plan.arrays(x.device)
    lengths = rowptr.diff()
    rows = torch.repeat_interleave(
        torch.arange(plan.num_nodes, device=x.device), lengths,
        output_size=plan.num_edges)
    k, q, v = x @ wk, x @ wq, x @ wv
    s = (k[col.long()] * q[rows]).sum(-1) / float(np.sqrt(x.shape[1]))
    # the row maximum is a constant of the softmax: no gradient through it
    mx = torch.segment_reduce(s.detach(), "max", lengths=lengths,
                              unsafe=True)
    mx = torch.where(torch.isinf(mx), 0.0, mx)
    ex = torch.exp(s - mx[rows])
    den = torch.segment_reduce(ex, "sum", lengths=lengths, unsafe=True)
    alpha = ex / (den[rows] + 1e-16)
    return spmm_csr(v, alpha, plan, weights_padded=True)


def hetero_attention(x, wk, wq, wv, plans, owned, group=None):
    """The relation-sharded attention: the sum over this process's
    relations ``owned`` (indices into the (R, D, D) weights and
    ``plans``) of `relation_attention`, summed over the group; x enters
    replicated, so its gradient is whole on every process; the weights'
    gradients are this process's relations' (sum them over the group for
    the whole)."""
    from gammagl_tpu_torch.parallel.spmm import (_copy_to_group,
                                                 _reduce_from_group)
    size = _size(group)
    x = _copy_to_group(x, group, size)
    out = None
    for r in owned:
        o = relation_attention(x, wk[r], wq[r], wv[r], plans[r])
        out = o if out is None else out + o
    return _reduce_from_group(out, group, size)


def hetero_step(rel_ei, x, wk, wq, wv, device):
    """The output, and the gradients of x and wk of the sum of its squares
    (wk's summed over the group), with relation r on process r (every
    relation in one process)."""
    from gammagl_tpu_torch.ops.cuda import build_csr_plan
    n = x.shape[0]
    owned = [_rank()] if _size() > 1 else range(len(rel_ei))
    plans = {r: build_csr_plan(rel_ei[r][0], rel_ei[r][1], n)
             for r in owned}
    xt = to_device(x, device).requires_grad_()
    wkt = to_device(wk, device).requires_grad_()
    out = hetero_attention(xt, wkt, to_device(wq, device),
                           to_device(wv, device), plans, owned)
    (out ** 2).sum().backward()
    return out.detach(), xt.grad, _all_sum(wkt.grad)


def _dense_hetero(x, wk, wq, wv, rel_ei):
    """The JAX function's `_het_dense_ref`, float64 on the host."""
    n, d = x.shape
    total = torch.zeros(n, d, dtype=x.dtype)
    for r, (src, dst) in enumerate(rel_ei):
        src = torch.as_tensor(src, dtype=torch.long)
        dst = torch.as_tensor(dst, dtype=torch.long)
        k, q, v = x @ wk[r], x @ wq[r], x @ wv[r]
        s = (k[src] * q[dst]).sum(-1) / np.sqrt(d)
        mx = torch.full((n,), -np.inf, dtype=x.dtype).scatter_reduce(
            0, dst, s.detach(), "amax")
        mx = torch.where(torch.isinf(mx), 0.0, mx)
        ex = torch.exp(s - mx[dst])
        den = torch.zeros(n, dtype=x.dtype).index_add(0, dst, ex)
        alpha = ex / (den[dst] + 1e-16)
        total = total + torch.zeros(n, d, dtype=x.dtype).index_add(
            0, dst, alpha[:, None] * v[src])
    return total


def _tier_hetero(errs, rec, n_procs, device):
    rel_ei, x, wk, wq, wv = _hetero_case(False, n_procs)
    with rec.run("hetero_attn"):
        out, dx, dwk = hetero_step(rel_ei, x, wk, wq, wv, device)
    rx, rk = _t64(x).requires_grad_(), _t64(wk).requires_grad_()
    ref = _dense_hetero(rx, rk, _t64(wq), _t64(wv), rel_ei)
    _check(errs, "hetero_attn_out", out, ref, tol=TOLS["hetero_attn_out"])
    (ref ** 2).sum().backward()
    _check(errs, "hetero_attn_grad_x", dx, rx.grad,
           tol=TOLS["hetero_attn_grad_x"])
    _check(errs, "hetero_attn_grad_wk", dwk, rk.grad,
           tol=TOLS["hetero_attn_grad_wk"])


def _run_tiers(n_procs, device):
    """Every tier on this process, in the JAX function's order: (errs,
    loss, its `DpTpGrid`, the record)."""
    from gammagl_tpu_torch.parallel import (build_halo_partition,
                                            build_halo_partition_planned,
                                            build_hier_halo_partition,
                                            build_hier_halo_partition_planned,
                                            grid_world, hier_world,
                                            make_halo_spmm,
                                            make_halo_spmm_planned,
                                            make_hier_halo_spmm,
                                            make_hier_halo_spmm_planned)
    errs, rec = {}, _Record(device)
    tp = 2 if n_procs % 2 == 0 else 1
    dp = n_procs // tp
    grid = grid_world(dp, tp)
    loss = _tier_dp_tp(errs, rec, grid, device)

    x, ei, _, w_norm, _, _ = _gcn_case(False)
    n = x.shape[0]
    part = build_halo_partition(ei, n, n_procs, w_norm)
    _halo_checks(errs, "halo", rec, make_halo_spmm(part), part, x, ei,
                 w_norm, device)
    part = build_halo_partition_planned(ei, n, n_procs, w_norm, R=8, ET=128)
    _halo_checks(errs, "planned", rec, make_halo_spmm_planned(part), part,
                 x, ei, w_norm, device)
    _tier_attn(errs, rec, n_procs, x, ei, device)
    if n_procs % 2 == 0 and n_procs >= 4:
        hgrid = hier_world(2, n_procs // 2)
        part = build_hier_halo_partition(ei, n, 2, n_procs // 2, w_norm)
        _halo_checks(errs, "hier", rec, make_hier_halo_spmm(part, hgrid),
                     part, x, ei, w_norm, device, grad=False)
        part = build_hier_halo_partition_planned(ei, n, 2, n_procs // 2,
                                                 w_norm, R=8, ET=128)
        _halo_checks(errs, "hier_planned", rec,
                     make_hier_halo_spmm_planned(part, hgrid), part, x, ei,
                     w_norm, device)
    _tier_sp_ep_pp(errs, rec, n_procs, x, ei, w_norm, device)
    _tier_mb(errs, rec, n_procs, device)
    _tier_hetero(errs, rec, n_procs, device)
    return errs, loss, grid, rec


def _full_width(n_procs, device, rec, grid=None):
    """The dp_tp step on the arxiv-scale graph and the relation attention
    at `HETERO`'s sizes, with ``n_procs`` relations: {name: host array}.
    ``grid`` None is one process (the (1, 1) grid, every relation)."""
    from gammagl_tpu_torch.parallel import DpTpGrid
    grid = grid or DpTpGrid(0, 0, None, None, 1, 1)
    x, ei, y, w_norm, w1, w2 = _gcn_case(True)
    signs = []
    with rec.run("dp-tp"):
        loss, dw1, dw2 = dp_tp_step(grid, x, ei, w_norm, y, w1, w2, device,
                                    relu_signs=signs)
    del x, ei
    rel_ei, hx, wk, wq, wv = _hetero_case(True, n_procs)
    with rec.run("het-r"):
        out, dx, dwk = hetero_step(rel_ei, hx, wk, wq, wv, device)
    return {"dp_tp_loss": loss.cpu().numpy(), "dp_tp_grad_w1": dw1.numpy(),
            "dp_tp_grad_w2": dw2.numpy(),
            "hetero_attn_out": out.cpu().numpy(),
            "hetero_attn_grad_x": dx.cpu().numpy(),
            "hetero_attn_grad_wk": dwk.numpy(), "relu_signs": signs[0]}


def _worker(tmp, rank):
    """One process of `dryrun_multichip`: joins the gloo group over a file
    store in ``tmp``, runs the tiers (and the full-width steps when asked),
    prints the summary lines on rank 0 and writes result<rank>.json."""
    with open(os.path.join(tmp, "config.json")) as f:
        cfg = json.load(f)
    n_procs, device = cfg["procs"], resolve_device(cfg["device"])
    if device.type == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=n_procs,
                            timeout=datetime.timedelta(seconds=cfg["timeout"]))
    try:
        errs, loss, grid, rec = _run_tiers(n_procs, device)
        dp, tp = grid.dp, grid.tp
        if rank == 0:
            worst = max(errs.values())
            tiers = " ".join(f"{k}={v:.1e}" for k, v in errs.items())
            print(f"dryrun_multichip({n_procs}): mesh=({dp},{tp}) "
                  f"loss={loss:.4f} parity max_rel_err={worst:.2e}")
            print(f"per-tier rel err: {tiers}", flush=True)
        if cfg["full_width"]:
            got = _full_width(n_procs, device, rec, grid)
            if rank == 0:
                np.savez(os.path.join(tmp, "full_width.npz"), **got)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.json"), "w") as f:
        json.dump({"rank": rank, "errs": errs, "loss": loss, "mesh": [dp, tp],
                   "launches": rec.launches, "ms": rec.ms}, f)


def _roofline_lines(n_procs):
    """The JAX function's two scaling-roofline lines (the arxiv-scale
    power-law graph of its seed, the halo partition with and without the
    balanced relabeling), each with the JAX package's TPU v5e rates and
    with `HwModel()`'s H100 rates."""
    from gammagl_tpu_torch.parallel import (HwModel, build_halo_partition,
                                            halo_scaling_estimate)
    rng = np.random.default_rng(0)
    nb, eb = 169_343, 2_315_598
    ei = np.stack([rng.integers(0, nb, eb),
                   (nb * (rng.random(eb) ** 1.5)).astype(np.int64)])
    lines = []
    for label, bal in (("default", True), ("balance=False", False)):
        part = build_halo_partition(ei, nb, n_procs, balance=bal)
        rows = part.num_parts * part.halo_per_peer
        kw = dict(num_parts=part.num_parts,
                  edges_per_part=part.edge_index.shape[2],
                  halo_rows_sent=rows, feat_dim=256, total_edges=eb)
        for rates, hw in (("TPU v5e, the JAX package's", HwModel(**_JAX_V5E)),
                          ("NVIDIA H100, HwModel()", HwModel())):
            est = halo_scaling_estimate(overlap=True, hw=hw, **kw)
            flat = halo_scaling_estimate(overlap=False, hw=hw, **kw)
            lines.append(
                f"scaling roofline (arxiv-scale, F=256 bf16, {n_procs} "
                f"dev, {label} order): t_compute "
                f"{est['t_compute_s'] * 1e3:.2f}ms t_ici "
                f"{est['t_ici_s'] * 1e3:.2f}ms -> efficiency "
                f"{est['efficiency']:.1%} overlapped / "
                f"{flat['efficiency']:.1%} flat (halo rows/device "
                f"{rows:,}) [rates: {rates}]")
    return lines


def _full_width_check(tmp, n_procs, device):
    """The processes' full-width results against the same steps in this
    process: {name: max |got - want| / max |want|, "relu_flips": ReLU
    inputs whose sign differs}; raises past `FULL_TOL` (`FULL_RELU_TOL`
    for a gradient behind the ReLU when any flipped)."""
    got = np.load(os.path.join(tmp, "full_width.npz"))
    want = _full_width(n_procs, device, _Record(device))
    signs = want.pop("relu_signs")
    flips = int(np.unpackbits(got["relu_signs"] ^ signs).sum())
    errs, bad = {}, {}
    for name, w in want.items():
        errs[name] = float(np.abs(got[name] - w).max()
                           / max(np.abs(w).max(), 1e-30))
        tol = FULL_RELU_TOL if flips and name in BEHIND_RELU else FULL_TOL
        if not errs[name] < tol:
            bad[name] = (errs[name], tol)
    if bad:
        raise RuntimeError(f"full-width steps in {n_procs} processes against "
                           f"one: {bad} (error, tolerance); {flips} ReLU "
                           "inputs changed sign")
    return {**errs, "relu_flips": flips}


def dryrun_multichip(n_procs, device=None, full_width=False, timeout=900):
    """Every parallel tier in ``n_procs`` gloo processes on ``device``
    (None: the card, which the processes share), each held against a
    one-process dense reference (see the module's docstring); prints the
    roofline lines and rank 0's two summary lines.

    ``full_width`` also runs the dp_tp step on the arxiv-scale graph and
    the relation attention at `HETERO`'s sizes in the same processes, and
    holds them against the same steps in this process at `FULL_TOL`.

    Returns {"errs", "loss", "mesh", "launches" and "ms" (a list by rank
    of {tier: ...}), "roofline" (the printed lines), "full_width" (its
    errors, when asked), "seconds"}. Raises when a process fails (its
    log in the message) or the run outlasts ``timeout`` seconds."""
    t_start = time.perf_counter()
    device = resolve_device(device)
    n_procs = int(n_procs)
    if n_procs < 1:
        raise ValueError(f"{n_procs} processes")
    if device.type == "cuda":  # built once here, not in every process
        from gammagl_tpu_torch.ops.cuda._build import load_library
        load_library()
    tmp = tempfile.mkdtemp(prefix="gammagl_dryrun_")
    procs = []
    try:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({"procs": n_procs, "device": device.type,
                       "full_width": bool(full_width),
                       "timeout": int(timeout)}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for r in range(n_procs):
            with open(os.path.join(tmp, f"out{r}.txt"), "w") as out, \
                    open(os.path.join(tmp, f"err{r}.txt"), "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gammagl_tpu_torch.entry",
                     "--worker", tmp, str(r)], cwd=ROOT, env=env,
                    stdout=out, stderr=err))
        roofline = _roofline_lines(n_procs)   # while the processes run
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs if p.poll() is not None):
                break  # a process failed: the others wait on it
            if time.monotonic() > deadline:
                raise RuntimeError(f"dryrun_multichip({n_procs}): the "
                                   f"processes ran past {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.poll() is not None
                  and p.returncode]
        if failed:
            logs = "\n".join(
                f"-- process {r} exited {procs[r].returncode}:\n"
                + open(os.path.join(tmp, f"err{r}.txt")).read()[-4000:]
                for r in failed)
            raise RuntimeError(f"dryrun_multichip({n_procs}) failed in "
                               f"process(es) {failed}:\n{logs}")
        for line in roofline:
            print(line)
        print(open(os.path.join(tmp, "out0.txt")).read(), end="",
              flush=True)
        results = []
        for r in range(n_procs):
            with open(os.path.join(tmp, f"result{r}.json")) as f:
                results.append(json.load(f))
        out = {"errs": results[0]["errs"], "loss": results[0]["loss"],
               "mesh": tuple(results[0]["mesh"]),
               "launches": [res["launches"] for res in results],
               "ms": [res["ms"] for res in results], "roofline": roofline}
        if full_width:
            out["full_width"] = _full_width_check(tmp, n_procs, device)
        out["seconds"] = time.perf_counter() - t_start
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="The forward of entry(), then dryrun_multichip.")
    p.add_argument("--procs", type=int, default=4,
                   help="processes of the dry run (default 4)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, default) or cpu")
    p.add_argument("--worker", nargs=2, metavar=("DIR", "RANK"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.worker[0], int(args.worker[1]))
        return
    fn, example = entry(args.device)
    with torch.no_grad():
        out = fn(*example)
    print("entry forward:", tuple(out.shape))
    dryrun_multichip(args.procs, args.device)


if __name__ == "__main__":
    main()
