#!/usr/bin/env python3
"""Check and time the SDDMM and expand kernels of the tree this script lies
in, on one card, and print one JSON line.

    python3 scripts/sddmm_probe.py [--variant NAME] [--check-only]
                                   [--no-sweep] [--expand-only]

First the kernels are held to their plain versions. The SDDMM (1e-5, f32
dots) at the (H, F) of tests/test_torch_cuda.py in f32 and bf16, gathered
and per edge, on a small graph with empty rows, on chip_smoke.py's hub
graph (a 1,200,000-edge star and a 5,000-edge hub, seed SEED + 8) and
with rows one element off their alignment; each call must launch the
kernel once, and, where the tree cuts rows into work items, no fold. The
expand (the copy bitwise, the scaled form at 1e-5 / 1e-2 in f32 / bf16)
at C = 7, 64 and 349 on the small graph, the hub graph and an x one
element off its alignment, one launch a call, repeats bitwise equal. The
kernels' registers and spill bytes (``-Xptxas -v``) are printed. Then the
times, each the mean of 20 calls after 3 (CUDA events; 10 on the hub
graph and at C = 349), taken twice in this process, on the arxiv-shape
graph (chip_smoke.py's, seed 0): the SDDMM gathered at F = 256 (TPU row 8)
and per edge at (H, F) = (8, 8) (TPU row 6), both bf16, beside
`spmm_csr` at F = 256 and `segment_sum_csr` at C = 64 on the same graph,
the expand at C = 64 and 40 (row 9) and the scaled expand at (8, 8) (row
7), and chip_smoke.py phase 10's SDDMM pair call traced twice (host ms,
device busy time); on the hub graph the SDDMM in both forms at (1, 256),
(8, 8) and (2, 640) beside `spmm_csr` and `segment_sum_csr` at the same
width, and the expand at C = 64; on chip_smoke.py's flattened typed graph
(phase 26: 300,000 nodes, 5,000,000 edges) the expand at RGCN's class
width, C = 349 f32, beside `repeat_interleave` and `index_select`. Where
the tree cuts rows into work items (`EDGE_SPLIT`, or `SDDMM_SPLIT` in a
tree whose expand walks a row on one warp), the rows of the kernels that
walk them are also timed at each K of SPLIT_SWEEP. ``--expand-only``
leaves out the SDDMM's checks and times, the pair call and the typed
graph's library calls.

To compare commits on one card, copy this script into another tree (a
parent unpacked with `git archive`) and run both trees in turns in one
call (parent, change, change, parent). ``--variant`` rebuilds the kernels
from a copy of csrc/ rewritten as VARIANTS says, so variants run in turns
too. Needs nvcc and a CUDA card; imports no JAX.
"""

import argparse
import importlib
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

mod = importlib.import_module("gammagl_tpu_torch.ops.cuda.sddmm_csr")
_sddmm, _expand = mod._sddmm, mod._expand
# the tree's item size: one for both kernels, or, in a tree whose expand
# walks a row on one warp, the SDDMM's alone
SPLIT = next((n for n in ("EDGE_SPLIT", "SDDMM_SPLIT") if hasattr(mod, n)),
             None)

SPLIT_SWEEP = (64, 128, 256, 512, 1024, 2048)
EXPAND_WIDTHS = ((7, 7), (64, 8), (349, 1))
SHAPES = ((1, 7), (8, 8), (1, 40), (1, 256), (2, 640))
HUB_SHAPES = ((1, 256), (8, 8), (2, 640))

# name -> [(source file, text, its replacement)]
_STAGES = "constexpr int kSddmmStages = 4;"
_BLOCKS = "constexpr int kSddmmBlocks = 4;"
_BATCH = "constexpr int kSddmmBatch = 8;"
VARIANTS = {
    # the ring 8 or 2 edges deep (16 KB -> 32 / 8 KB a block)
    "stages8": [("sddmm_csr.cu", _STAGES, "constexpr int kSddmmStages = 8;")],
    "stages2": [("sddmm_csr.cu", _STAGES, "constexpr int kSddmmStages = 2;")],
    # registers capped for 2 or 3 blocks an SM (128 or 85, from 64)
    "blocks2": [("sddmm_csr.cu", _BLOCKS, "constexpr int kSddmmBlocks = 2;")],
    "blocks3": [("sddmm_csr.cu", _BLOCKS, "constexpr int kSddmmBlocks = 3;")],
    # diagnostics, wrong on purpose (their checks are skipped): no read of
    # xd[row] (ones), scores stored only where they equal 12345 (never),
    # no sum over a head's lanes
    "noxd": [("sddmm_csr.cu",
              "    if (cols) load_vec<T, V>(xd + it.row * HF + off, xv);",
              "    if (cols) for (int i = 0; i < V; ++i) xv[i] = 1.f;")],
    "nostore": [("sddmm_csr.cu",
                 "out[(it.lo + j - k + held) * g.H + h] = sum;",
                 "if (sum == 12345.f) "
                 "out[(it.lo + j - k + held) * g.H + h] = sum;")],
    "nosum": [("sddmm_csr.cu",
               "const float sum = head_sums<B>(pend, g.lh, li, mask);",
               "const float sum = pend[0];")],
    # a head of 8 lanes or more sums runs of 4, 16 or 1 edge (a tree an
    # edge)
    "batch4": [("sddmm_csr.cu", _BATCH, "constexpr int kSddmmBatch = 4;")],
    "batch16": [("sddmm_csr.cu", _BATCH,
                 "constexpr int kSddmmBatch = 16;")],
    "batch1": [("sddmm_csr.cu", _BATCH, "constexpr int kSddmmBatch = 1;")],
    "stages8_blocks2": [
        ("sddmm_csr.cu", _STAGES, "constexpr int kSddmmStages = 8;"),
        ("sddmm_csr.cu", _BLOCKS, "constexpr int kSddmmBlocks = 2;")],
    "stages8_blocks3": [
        ("sddmm_csr.cu", _STAGES, "constexpr int kSddmmStages = 8;"),
        ("sddmm_csr.cu", _BLOCKS, "constexpr int kSddmmBlocks = 3;")],
    # the expand's store rounds on aligned 512-byte spans for rows of a
    # multiple of 16 bytes too (PERF.md section 7)
    "expand_rotate_all": [("sddmm_csr.cu",
                           "  if constexpr (!kAligned)\n    r = ",
                           "  if (true)\n    r = ")],
    # the scaled expand reads a scale an element on every width, also
    # where a chunk lies in one head (kHeadChunk's instance)
    "expand_scale_each": [("sddmm_csr.cu",
                           "      if constexpr (kHeadChunk) {",
                           "      if constexpr (false) {")],
}


DIAGNOSTIC = ("noxd", "nostore", "nosum")  # wrong on purpose


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


def print_resources(lib):
    """Registers and spill bytes of the edge kernels, from the build log."""
    log = open(os.path.splitext(lib._name)[0] + ".log").read()
    name = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
            name = name if ("sddmm" in name or "expand" in name) else None
        elif name and ("registers" in line or "spill" in line):
            print(f"  {name[:100]}: {line.strip()}")


def check(label, a, xd, plan, H, gather, cut):
    """One call against the plain version at 1e-5: one launch, no fold
    (``cut``: the tree cuts rows into items), a repeat bitwise equal."""
    c0, f0 = k.sddmm_csr.launches, k.csr_fold.launches
    got = _sddmm(a, xd, plan, H, gather)
    torch.cuda.synchronize()
    if k.sddmm_csr.launches - c0 != 1 or (cut and k.csr_fold.launches != f0):
        raise SystemExit(f"{label}: launches {k.sddmm_csr.launches - c0}, "
                         f"folds {k.csr_fold.launches - f0}")
    err = cs.check_close(label, got, k.sddmm_csr_reference(a, xd, plan, H,
                                                           gather), 1e-5)
    if not torch.equal(got, _sddmm(a, xd, plan, H, gather)):
        raise SystemExit(f"{label}: repeats differ")
    return err


def checks(gen, hub, cut):
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n_dst, n_src, e = 700, 900, 5000
    small = k.build_csr_plan(rng.integers(0, n_src, e),
                             2 * rng.integers(0, 300, e), n_dst,
                             num_src=n_src)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for H, F in SHAPES:
            # a tree that walks a row on one warp: not the star 20 times
            for plan, name in ((small, "small"), (hub, "hub"))[:1 + cut]:
                xd = torch.randn(plan.num_nodes, H * F,
                                 generator=gen).to(dev, dtype)
                for gather in (True, False):
                    rows = plan.num_src if gather else plan.num_edges
                    a = torch.randn(rows, H * F, generator=gen).to(dev, dtype)
                    err = max(err, check(
                        f"{name} {dtype} ({H},{F}) gather={gather}", a, xd,
                        plan, H, gather, cut))
            # rows one element off their alignment: a narrower load
            flat = torch.randn(small.num_src * H * F + 1,
                               generator=gen).to(dev, dtype)
            a = flat[1:].view(small.num_src, H * F)
            xd = torch.randn(small.num_nodes * H * F + 1,
                             generator=gen).to(dev, dtype)[1:].view(
                                 small.num_nodes, H * F)
            err = max(err, check(f"misaligned {dtype} ({H},{F})", a, xd,
                                 small, H, True, cut))
    return err


def expand_check(label, x, plan, scale, rtol):
    """The copy bitwise x[row(e)] and the scaled form within ``rtol`` of
    the plain version, one launch a call, repeats bitwise equal; returns
    the scaled form's max abs error."""
    c0 = k.expand_dst_csr.launches
    got = k.expand_dst_csr(x, plan)
    scaled = _expand(x, plan, scale)
    torch.cuda.synchronize()
    if k.expand_dst_csr.launches - c0 != 2:
        raise SystemExit(f"{label}: {k.expand_dst_csr.launches - c0} "
                         "launches for 2 calls")
    if not torch.equal(got, k.expand_dst_csr_reference(x, plan)):
        raise SystemExit(f"{label}: the copy is not bitwise x[row]")
    err = cs.check_close(f"scaled expand {label}", scaled,
                         k.expand_dst_csr_reference(x, plan, scale), rtol)
    if not (torch.equal(got, k.expand_dst_csr(x, plan))
            and torch.equal(scaled, _expand(x, plan, scale))):
        raise SystemExit(f"{label}: repeats differ")
    return err


def expand_checks(gen, hub):
    """The expand on the small graph, on an x one element off its
    alignment and on the hub graph, at EXPAND_WIDTHS in f32 and bf16."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    n_dst, e = 700, 5000
    small = k.build_csr_plan(rng.integers(0, 900, e),
                             2 * rng.integers(0, 300, e), n_dst, num_src=900)
    err = 0.0
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for C, H in EXPAND_WIDTHS:
            for name, plan in (("small", small), ("hub", hub)):
                x = torch.randn(plan.num_nodes, C, generator=gen).to(dev,
                                                                     dtype)
                scale = torch.randn(plan.num_edges, H, generator=gen).to(dev)
                err = max(err, expand_check(f"{name} {dtype} C={C} H={H}",
                                            x, plan, scale, rtol))
            flat = torch.randn(n_dst * C + 1, generator=gen).to(dev, dtype)
            scale = torch.randn(e, H, generator=gen).to(dev)
            err = max(err, expand_check(
                f"misaligned {dtype} C={C} H={H}",
                flat[1:].view(n_dst, C), small, scale, rtol))
    return err


def typed_plan(dev):
    """chip_smoke.py phase 26's flattened typed graph's CSR plan."""
    from gammagl_tpu_torch.data import HeteroGraph
    from gammagl_tpu_torch.examples import simplehgn_trainer
    return cs.flat_typed_graph(k, simplehgn_trainer,
                               cs.hgt_graph(HeteroGraph), dev)[1]


def expand_cases(gen, plan, hub, typed):
    """{label: (call, iterations, bound, floor)} of the expand: row 9 at C
    = 64 and 40 bf16 and row 7 at (8, 8) bf16 on the arxiv-shape graph,
    row 9 at C = 64 bf16 on the hub graph and at C = 349 f32 on the
    flattened typed graph, with the time to fill an output of that size
    (the card's write rate, a floor no copy beats); and the typed graph's
    library calls (`repeat_interleave`, `index_select`) at that width."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    out, library = {}, {}
    N, E = plan.num_nodes, plan.num_edges
    for C in (64, 40):
        xd = torch.randn(N, C, generator=gen).to(dev, bf)
        out[f"row 9: expand C={C}"] = (
            lambda xd=xd: k.expand_dst_csr(xd, plan), 20,
            cs.bound(N * C * 2 + (N + 1) * 8 + E * C * 2, 0), None)
    H = 8
    xd = torch.randn(N, H * 8, generator=gen).to(dev, bf)
    g = torch.rand(E, H, generator=gen).to(dev)
    out["row 7: scaled expand (8,8)"] = (
        lambda: _expand(xd, plan, g), 20,
        cs.bound(N * 64 * 2 + E * H * 4 + (N + 1) * 8 + E * 64 * 2, E * 64),
        None)
    N, E = hub.num_nodes, hub.num_edges
    xh = torch.randn(N, 64, generator=gen).to(dev, bf)
    out["hub expand C=64"] = (lambda: k.expand_dst_csr(xh, hub), 10,
                              cs.bound(N * 64 * 2 + (N + 1) * 8
                                       + E * 64 * 2, 0), None)
    N, E, C = typed.num_nodes, typed.num_edges, 349
    xt = torch.randn(N, C, generator=gen, dtype=torch.float32).to(dev)
    out["row 9: expand C=349 f32 typed"] = (
        lambda: k.expand_dst_csr(xt, typed), 10,
        cs.bound(N * C * 4 + (N + 1) * 8 + E * C * 4, 0), None)
    # a diagnostic width of the same bytes whose rows are a multiple of 16
    # bytes (the aligned instance: one load a chunk, no scalar stores)
    xa = torch.randn(N, C - 1, generator=gen, dtype=torch.float32).to(dev)
    out["expand C=348 f32 typed (aligned rows)"] = (
        lambda: k.expand_dst_csr(xa, typed), 10,
        cs.bound(N * (C - 1) * 4 + (N + 1) * 8 + E * (C - 1) * 4, 0), None)
    out_t = torch.empty(E, C, device=dev)
    out["write floor: fill (E, 349) f32 typed"] = (
        lambda: out_t.fill_(1.0), 10, cs.bound(E * C * 4, 0), None)
    rowptr = typed.arrays(dev)[0]
    counts, rows = rowptr.diff(), mod._csr_rows(typed, dev)
    library["repeat_interleave C=349 f32 typed"] = (
        lambda: torch.repeat_interleave(xt, counts, dim=0, output_size=E),
        10, None, None)
    library["index_select C=349 f32 typed"] = (
        lambda: xt.index_select(0, rows), 10, None, None)
    return out, library


def arxiv_cases(gen, plan):
    """{label: (call, iterations, bound)} on the arxiv-shape graph."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    N, Ns, E = plan.num_nodes, plan.num_src, plan.num_edges
    F, (H, Fh) = 256, (8, 8)
    x = torch.randn(Ns, F, generator=gen).to(dev, bf)
    msg = torch.randn(E, H * Fh, generator=gen).to(dev, bf)
    xd = torch.randn(N, H * Fh, generator=gen).to(dev, bf)
    v = torch.randn(E, 64, generator=gen).to(dev, bf)
    return {
        "row 8: sddmm F=256 gathered": (
            lambda: _sddmm(x, x, plan, 1, True), 20,
            cs.bound(Ns * F * 2 + E * 4 + (N + 1) * 8 + E * 4, 2 * E * F),
            E * F * 2),
        "row 6: sddmm (8,8) per edge": (
            lambda: _sddmm(msg, xd, plan, H, False), 20,
            cs.bound(E * 64 * 2 + N * 64 * 2 + (N + 1) * 8 + E * H * 4,
                     2 * E * 64), None),
        "spmm_csr F=256": (lambda: k.spmm_csr(x, None, plan), 20,
                           cs.bound(Ns * F * 2 + E * 4 + (N + 1) * 8
                                    + N * F * 2, E * F), E * F * 2),
        "segment_sum_csr C=64": (
            lambda: k.segment_sum_csr(v, plan), 20,
            cs.bound(E * 64 * 2 + (N + 1) * 8 + N * 64 * 2, E * 64), None),
    }


def hub_cases(gen, hub, cut):
    """{label: (call, iterations, bound)} of the SDDMM on the hub graph;
    that of a tree that walks a row on one warp is timed once."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    N, Ns, E = hub.num_nodes, hub.num_src, hub.num_edges
    out = {}
    for H, F in HUB_SHAPES:
        C = H * F
        x = torch.randn(Ns, C, generator=gen).to(dev, bf)
        msg = torch.randn(E, C, generator=gen).to(dev, bf)
        xd = torch.randn(N, C, generator=gen).to(dev, bf)
        n = 20 if cut else 1
        out[f"hub sddmm ({H},{F}) gathered"] = (
            lambda x=x, xd=xd, H=H: _sddmm(x, xd, hub, H, True), n,
            cs.bound(Ns * C * 2 + N * C * 2 + E * 4 + (N + 1) * 8
                     + E * H * 4, 2 * E * C), E * C * 2)
        out[f"hub sddmm ({H},{F}) per edge"] = (
            lambda m=msg, xd=xd, H=H: _sddmm(m, xd, hub, H, False), n,
            cs.bound(E * C * 2 + N * C * 2 + (N + 1) * 8 + E * H * 4,
                     2 * E * C), None)
        out[f"hub spmm_csr F={C}"] = (
            lambda x=x: k.spmm_csr(x, None, hub), 20,
            cs.bound(Ns * C * 2 + E * 4 + (N + 1) * 8 + N * C * 2, E * C),
            E * C * 2)
        out[f"hub segment_sum_csr C={C}"] = (
            lambda m=msg: k.segment_sum_csr(m, hub), 20,
            cs.bound(E * C * 2 + (N + 1) * 8 + N * C * 2, E * C), None)
    return out


def pair_profile(gen, plan):
    """chip_smoke.py phase 10's SDDMM pair call (`sddmm_csr(x, x)` at F =
    256 and `sddmm_csr_mh` on per-edge (8, 8) rows, each forward and
    backward), traced: host ms and device busy time a call."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    N, E = plan.num_nodes, plan.num_edges
    x = torch.randn(N, 256, generator=gen).to(dev, bf).requires_grad_()
    msg = torch.randn(E, 8, 8, generator=gen).to(dev, bf).requires_grad_()
    xd = torch.randn(N, 8, 8, generator=gen).to(dev, bf).requires_grad_()

    def pair():
        k.sddmm_csr(x, x, plan).sum().backward()
        k.sddmm_csr_mh(None, xd, plan, msg=msg).sum().backward()

    return cs.profile("sddmm_pair", pair)


def timed(calls, runs=2):
    """{label: [ms of each run]}: the calls in turns, ``runs`` times."""
    ms = {label: [] for label in calls}
    for _ in range(runs):
        for label, (fn, iters, _, _) in calls.items():
            ms[label].append(cs.cuda_ms(fn, iters=iters,
                                        warmup=3 if iters > 1 else 1))
    return ms


def report(calls, ms):
    for lb, t in ms.items():
        b, floor = calls[lb][2], calls[lb][3]
        fl = ("" if floor is None else ", gathered-row floor "
              f"{floor / cs.HBM_BYTES_PER_S * 1e3:.4f} ms")
        share = ("" if b is None else
                 f"; bound {b['bound_ms']:.4f} ms by {b['bound_by']}, "
                 f"{b['bound_ms'] / np.mean(t):.3f} of it{fl}")
        print(f"{lb}: {np.mean(t):.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in t)}){share}")


def sweep_split(name, values, rows):
    """{K: {label: [ms]}}: the rows timed once at each item size K, the
    module's constant ``name`` set to K."""
    base, sweep = getattr(mod, name), {}
    for K in values:
        setattr(mod, name, K)
        sweep[K] = timed(rows, runs=1)
    setattr(mod, name, base)
    for K, t in sweep.items():
        print(f"{name} {K}: " + "; ".join(
            f"{lb} {v[0]:.4f}" for lb, v in t.items()))
    return sweep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--check-only", action="store_true",
                    help="build, check against the plain version, stop")
    ap.add_argument("--no-sweep", action="store_true",
                    help="leave out the sweep of the item size")
    ap.add_argument("--expand-only", action="store_true",
                    help="check and time the expand alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cut = SPLIT is not None
    items = SPLIT == "EDGE_SPLIT"  # the expand walks the items too
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    out = {"tree": ROOT, "variant": args.variant, "items": cut,
           "expand_items": items}
    with tempfile.TemporaryDirectory() as work:
        if args.variant:
            use_variant(args.variant, work)
        lib = _build.load_library()
        print_resources(lib)
        hub = cs.hub_plan(k, cs.SEED + 8)
        if args.variant not in DIAGNOSTIC:
            out["expand_check_max_abs_err"] = expand_checks(gen, hub)
            if not args.expand_only:
                out["check_max_abs_err"] = checks(gen, hub, cut)
        if not args.check_only:
            plan = cs.arxiv_graph(Graph).csr_plan()
            expand, library = expand_cases(gen, plan, hub, typed_plan(dev))
            calls = dict(expand)
            if not args.expand_only:
                calls.update({**arxiv_cases(gen, plan),
                              **hub_cases(gen, hub, cut), **library})
            ms = timed(calls)
            sweep = {}
            if not args.expand_only:
                out["pair"] = [pair_profile(gen, plan) for _ in range(2)]
            out["ms"] = {lb: float(np.mean(t)) for lb, t in ms.items()}
            out["runs"] = ms
            report(calls, ms)
            for p in out.get("pair", ()):
                print(f"sddmm pair call: host {p['span_us'] / 1e3:.3f} ms, "
                      f"device busy {p['busy_us'] / 1e3:.3f} ms")
            # the rows of the kernels that walk the items
            rows = {lb: c for lb, c in calls.items()
                    if ("sddmm" in lb and not args.expand_only)
                    or (items and lb in expand)}
            if cut and rows and not args.no_sweep:
                sweep = sweep_split(SPLIT, SPLIT_SWEEP, rows)
            out["split_sweep"] = sweep
        del lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out["card"] = smi
    print(smi.splitlines()[0])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
