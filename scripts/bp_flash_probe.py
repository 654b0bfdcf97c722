#!/usr/bin/env python3
"""Time the block-pair forward and the flash kernels of the tree this
script lies in, on one card, and print one JSON line.

    python3 scripts/bp_flash_probe.py [--variant NAME] [--flash-only]

The shapes are the main paths' (chip_smoke.py's generators, seed 0): the
block-pair forward at F = 256 and 40 (bf16, GCN weights) on the banded
graph after `reorder_rcm`, beside `torch.sparse.mm` and `spmm_csr` on the
same graph, and its dx on the transpose plan at F = 256; the flash forward
and backward at GAT's (H, F) = (8, 8) and (1, 40) on the arxiv-shape graph
(gathered rows, keep in the caller's order, slope 0.2) and at HGT's (4, 64)
on bench.py:185's relation (per-edge rows and keep in CSR order, slope 1,
as `flash_softmax_spmm_mh`), and the flash forward at (8, 8) and (1, 40)
on chip_smoke.py's hub graph (a 1,200,000-edge star and a 5,000-edge hub;
rows cut into work items where the tree does that) beside `spmm_csr` at
F = H*F on the same graph. Each time is the mean of 20 calls after 3
(5 on the hub graph; CUDA events), taken twice in this process; each
kernel's output is held to its plain version (max abs error printed) and
digested (sha256: equal digests in two trees' runs are equal bits).
Then the gcn twin's train
step on the banded graph with `auto_plan()`'s plan (chip_smoke.py's phase
20 without its plain path): the host-clock median of 20 steps, each
ended by a synchronize.

To compare commits on one card, copy this script into another tree (a
parent unpacked with `git archive`) and run both trees in turns in one
call (parent, change, change, parent): it uses only what chip_smoke.py and
the package have had since the block-pair slice.

``--variant`` rebuilds the kernels from a copy of the whole csrc/ (the
shared headers, `common.cuh` and `csr_items.cuh`, too) rewritten as
VARIANTS says, so variants of this tree's kernels run in turns too. Needs
nvcc and a CUDA card; imports no JAX.
"""

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gammagl_tpu_torch.data import Graph  # noqa: E402
from gammagl_tpu_torch.ops import cuda as k  # noqa: E402
from gammagl_tpu_torch.ops.cuda import _build  # noqa: E402

# name -> [(source file, text, its replacement)]
_FWD_STAGES = "constexpr int kFwdStages = 4;"
_FWD_BLOCKS = "constexpr int kFwdBlocks = 3;"
VARIANTS = {
    # the flash forward's ring 8 or 2 edges deep (24 KB -> 48 / 12 KB a
    # block), and its registers capped for 1, 2 or 4 blocks an SM (255,
    # 128 or 64 registers, from 85)
    "fwd_stages8": [("flash_attention.cu", _FWD_STAGES,
                     "constexpr int kFwdStages = 8;")],
    "fwd_stages2": [("flash_attention.cu", _FWD_STAGES,
                     "constexpr int kFwdStages = 2;")],
    "fwd_blocks1": [("flash_attention.cu", _FWD_BLOCKS,
                     "constexpr int kFwdBlocks = 1;")],
    "fwd_blocks2": [("flash_attention.cu", _FWD_BLOCKS,
                     "constexpr int kFwdBlocks = 2;")],
    "fwd_blocks4": [("flash_attention.cu", _FWD_BLOCKS,
                     "constexpr int kFwdBlocks = 4;")],
    # the flash backward's ring 8 edges deep (24 KB -> 48 KB a block)
    "bwd_stages8": [("flash_attention.cu", "constexpr int kBwdStages = 4;",
                     "constexpr int kBwdStages = 8;")],
    # the flash backward's register cap where a warp takes several edges
    # at once: none (1 block an SM), 64 (4 blocks)
    "bwd_narrow1": [("flash_attention.cu", "constexpr int kNarrowBlocks = 3;",
                     "constexpr int kNarrowBlocks = 1;")],
    "bwd_narrow4": [("flash_attention.cu", "constexpr int kNarrowBlocks = 3;",
                     "constexpr int kNarrowBlocks = 4;")],
    # the block-pair forward at 64 bf16 columns a chunk (8 lanes a group)
    "bp_ft64": [("block_pair.cu", "while (L < 16 && static_cast<int64_t>(L)",
                 "while (L < 8 && static_cast<int64_t>(L)")],
    # the block-pair forward's steps of half as many edges (2048 at L = 16)
    "bp_ahead4": [("block_pair.cu", "constexpr int kWeightsAhead = 8;",
                   "constexpr int kWeightsAhead = 4;")],
}


def use_variant(name, work):
    """Point the package's build at a rewritten copy of csrc/."""
    src = os.path.join(work, "csrc")
    shutil.copytree(_build.CSRC_DIR, src)
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(src, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"variant {name}: {fname} lacks {old!r}")
        open(path, "w").write(text.replace(old, new))
    _build.CSRC_DIR = type(_build.CSRC_DIR)(src)
    _build.BUILD_DIR = type(_build.BUILD_DIR)(os.path.join(work, "build"))


def err_of(got, want):
    """The max abs error over a result's tensors."""
    if isinstance(got, tuple):
        return max(err_of(a, b) for a, b in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def digest(got):
    """sha256 of a result's bytes: equal digests in two trees' runs mean
    bit-for-bit equal results."""
    h = hashlib.sha256()
    for t in got if isinstance(got, tuple) else (got,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def cases(flash_only=False):
    """{label: (kernel call, plain call, iterations)}; the flash kernels'
    alone with ``flash_only``."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    out = {}
    if not flash_only:
        block_pair_cases(out, gen)
    flash_cases(out, gen)
    return out


def block_pair_cases(out, gen):
    """The block-pair forward, dx and yardsticks on the banded graph."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    banded, _ = cs.banded_graph(Graph).reorder_rcm()
    bp = banded.auto_plan()
    csr = banded.csr_plan()
    ei = torch.from_numpy(banded.edge_index).to(dev)
    w = cs.gcn_weights(ei, cs.N_NODES)
    w_csr = k.pad_edge_weights(csr, w)
    rowptr, col, _ = csr.arrays(dev)
    A = torch.sparse_csr_tensor(rowptr, col.long(), w_csr.to(bf),
                                size=(csr.num_nodes, csr.num_src))
    for F in (256, 40):
        x = torch.randn(bp.num_src, F, generator=gen).to(dev, bf)
        if F == 256:
            x256 = x
        plain = (lambda x=x: k.spmm_block_pair_reference(x, w, bp))
        out[f"block_pair F={F}"] = (lambda x=x: k.spmm_block_pair(x, w, bp),
                                    plain, 20)
        out[f"torch.sparse.mm F={F}"] = (lambda x=x: torch.sparse.mm(A, x),
                                         plain, 20)
        out[f"spmm_csr F={F}"] = (lambda x=x: k.spmm_csr(
            x, w_csr, csr, weights_padded=True), plain, 20)
    # where the block pair's time goes at F = 256: weights in the plan's
    # order (no gather through w_perm) and none
    w_plan = w[torch.from_numpy(bp.w_perm).to(dev).long()]
    out["block_pair F=256 plan-order weights"] = (
        lambda x=x256: k.spmm_block_pair(x, w_plan, bp, weights_padded=True),
        lambda x=x256: k.spmm_block_pair_reference(x, w, bp), 20)
    out["block_pair F=256 unit weights"] = (
        lambda x=x256: k.spmm_block_pair(x, None, bp),
        lambda x=x256: k.spmm_block_pair_reference(x, None, bp), 20)
    tp = bp.transpose()
    g = torch.randn(bp.num_nodes, 256, generator=gen).to(dev, bf)
    out["block_pair dx F=256"] = (lambda: k.spmm_block_pair(g, w, tp),
                                  lambda: k.spmm_block_pair_reference(g, w,
                                                                      tp),
                                  20)


def flash_cases(out, gen):
    """The flash kernels at GAT's and HGT's shapes and on the hub graph."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    arxiv = cs.arxiv_graph(Graph).csr_plan()
    src, dst = cs.hgt_relation()
    rel = k.build_csr_plan(src, dst, cs.HGT_PAPERS, num_src=cs.HGT_AUTHORS)
    for plan, H, F, gather, slope in ((arxiv, 8, 8, True, 0.2),
                                      (arxiv, 1, 40, True, 0.2),
                                      (rel, 4, 64, False, 1.0)):
        s, a, msg, kp = cs._flash_inputs(gen, plan, H, F, bf, gather, True,
                                         dev)
        if not gather:
            a = None
        args = (s, a, msg, kp, plan, slope, gather)
        o, m, l = k.flash_forward(*args)
        gr = torch.randn(o.shape, generator=gen).to(dev, bf)
        bargs = (s, a, msg, kp, m, l, o, gr, plan, slope, gather)
        out[f"flash_forward ({H},{F})"] = (
            lambda args=args: k.flash_forward(*args),
            lambda args=args: k.flash_forward_reference(*args), 20)
        out[f"flash_backward ({H},{F})"] = (
            lambda b=bargs: k.flash_backward(*b)[1],
            lambda b=bargs: k.flash_backward_reference(*b)[1], 20)
    hub = cs.hub_plan(k, cs.SEED + 4)
    for H, F in ((8, 8), (1, 40)):
        s, a, msg, kp = cs._flash_inputs(gen, hub, H, F, bf, True, True, dev)
        args = (s, a, msg, kp, hub, 0.2, True)
        out[f"flash_forward hub ({H},{F})"] = (
            lambda args=args: k.flash_forward(*args),
            lambda args=args: k.flash_forward_reference(*args), 5)
        x = torch.randn(hub.num_src, H * F, generator=gen).to(dev, bf)
        out[f"spmm_csr hub F={H * F}"] = (
            lambda x=x: k.spmm_csr(x, None, hub),
            lambda x=x: k.spmm_csr_reference(x, None, hub), 5)


def step_ms(n=20):
    """Host-clock ms of the banded GCN train step, n steps after 2."""
    import time
    from gammagl_tpu_torch.examples import common
    from gammagl_tpu_torch.models import GCNModel
    from gammagl_tpu_torch.train import TrainState
    from gammagl_tpu_torch.utils import load_jax_params
    dev = torch.device("cuda")
    banded, _ = cs.banded_graph(Graph).reorder_rcm()
    plan = banded.auto_plan()
    x = torch.from_numpy(banded.x).to(dev)
    ei = torch.from_numpy(banded.edge_index).to(dev)
    y = torch.from_numpy(banded.y).to(dev)
    mask = torch.from_numpy(np.random.default_rng(0).random(x.shape[0])
                            < 0.54).to(dev)
    state = TrainState(cs.gcn_model(GCNModel, load_jax_params).to(dev),
                       cs.GCN_LR, cs.GCN_L2)
    times = []
    for _ in range(n + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        common.train_step(state, x, ei, y, mask, plan=plan)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times[2:]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--flash-only", action="store_true",
                    help="time the flash kernels only (no block pair, no "
                         "train step)")
    args = ap.parse_args()
    variant = args.variant
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    with tempfile.TemporaryDirectory() as work:
        if variant:
            use_variant(variant, work)
        k_lib = _build.load_library()
        log = open(os.path.splitext(k_lib._name)[0] + ".log").read()
        entry = None
        for line in log.splitlines():  # the kernels' registers, spills
            if "Compiling entry" in line:
                entry = next((n for n in ("block_pair_fwd_kernel",
                                          "flash_bwd_", "flash_fwd_")
                              if n in line), None)
                name = line.split("'")[1] if entry else None
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {name[:90]}: {line.strip()}")
        calls = cases(args.flash_only)
        errs = {}
        digests = {}
        for label, (fn, plain, _) in calls.items():
            errs[label] = err_of(fn(), plain())
            digests[label] = digest(fn())
        ms = {label: [] for label in calls}
        for _ in range(2):
            for label, (fn, _, iters) in calls.items():
                ms[label].append(cs.cuda_ms(fn, iters=iters))
        steps = [] if args.flash_only else step_ms()
        del k_lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for label, t in ms.items():
        print(f"{label}: {np.mean(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f}), max "
              f"abs err {errs[label]:.3e}")
    if steps:
        print(f"banded GCN train step: median {np.median(steps):.3f} ms, "
              f"quartiles {np.percentile(steps, 25):.3f} / "
              f"{np.percentile(steps, 75):.3f} ms over {len(steps)} steps")
    print(smi.splitlines()[0])
    print(json.dumps({"tree": ROOT, "variant": variant, "card": smi,
                      "ms": {lb: float(np.mean(t)) for lb, t in ms.items()},
                      "runs": ms, "max_abs_err": errs, "digests": digests,
                      "banded_train_step_ms": steps}))


if __name__ == "__main__":
    main()
