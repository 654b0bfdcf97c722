#!/usr/bin/env python3
"""Time the segment max (forward and backward) and the HGT attention
kernels of the tree this script lies in, on one card, and the GraphSAGE
and HGT paths that launch them; print one JSON line.

    python3 scripts/max_hgt_probe.py [--variant NAME]

The shapes are the main paths' (chip_smoke.py's generators, seed 0), all
bf16: the segment max gathered at F = 256 and 128 on the arxiv-shape graph
beside the port's `spmm_csr` on the same rows, per edge at F = 256 beside
`torch.segment_reduce`, its backward at F = 256 and 128; the gathered
forward and the backward at F = 256 on the hub graph (chip_smoke.py's: a
1,200,000-edge star and a 5,000-edge hub) beside `spmm_csr`; the HGT
forward and backward at (H, D) = (4, 64) on bench.py:185's relation (the
backward's variants below: its ring's depth and register cap). Each
time is the mean of 20 calls after 3 (CUDA events; 5 on the hub graph),
taken twice in this process; each output is held to its plain version
(max abs error printed) and digested (sha256: equal digests in two trees'
runs are equal bits). Then the paths, by the host clock around a
synchronize, the median of 20 after 3: a GraphSAGE (pool) request and
train step on the arxiv-shape graph (chip_smoke.py's phases 13-14 without
their plain paths) and an HGT eval forward on the typed graph (phase 15).

To compare commits on one card, copy this script into another tree (a
parent unpacked with `git archive`) and run both trees in turns in one
call (parent, change, change, parent): it uses only what chip_smoke.py and
the package have had since the hub-row slice of the CSR kernel.

``--variant`` rebuilds the kernels from a copy of the whole csrc/ (the
shared headers too) rewritten as VARIANTS says, so variants of this
tree's kernels run in turns too. Needs nvcc and a CUDA card; imports no
JAX.
"""

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gammagl_tpu_torch.data import Graph, HeteroGraph  # noqa: E402
from gammagl_tpu_torch.ops import cuda as k  # noqa: E402
from gammagl_tpu_torch.ops.cuda import _build  # noqa: E402

# name -> [(source file, text, its replacement)]
_HGT = "constexpr int kFwdStages = K == 1 ? 4 : 2;"
_HGT_BWD = "constexpr int kBwdStages = K == 1 ? 4 : 2;"
_HGT_BWD_BLOCKS = "constexpr int kBwdBlocks = K == 1 ? 5 : K == 2 ? 3 : 2;"
VARIANTS = {
    # the segment max's rings (forward and backward) 4 rows deep
    "max_stages4": [("segment_max.cu", "constexpr int kStages = 8;",
                     "constexpr int kStages = 4;")],
    # the segment max backward's register cap for 2 or 4 blocks an SM
    "max_bwd_blocks2": [("segment_max.cu", "constexpr int kBwdBlocks = 3;",
                         "constexpr int kBwdBlocks = 2;")],
    "max_bwd_blocks4": [("segment_max.cu", "constexpr int kBwdBlocks = 3;",
                         "constexpr int kBwdBlocks = 4;")],
    # the HGT forward's ring 8 or 2 edges deep at K = 1, or without its
    # register cap
    "hgt_stages8": [("hetero_flash.cu", _HGT,
                     "constexpr int kFwdStages = 8 / K;")],
    "hgt_stages2": [("hetero_flash.cu", _HGT,
                     "constexpr int kFwdStages = K == 1 ? 2 : 1;")],
    "hgt_nocap": [("hetero_flash.cu",
                   "__launch_bounds__(kFwdThreads, kFwdBlocks<K>)",
                   "__launch_bounds__(kFwdThreads)")],
    # the HGT backward's ring 8 or 2 edges deep at K = 1, and its register
    # cap: none, or 4 or 6 blocks an SM at K = 1 (128 or 85 registers)
    "hgt_bwd_stages8": [("hetero_flash.cu", _HGT_BWD,
                         "constexpr int kBwdStages = 8 / K;")],
    "hgt_bwd_stages2": [("hetero_flash.cu", _HGT_BWD,
                         "constexpr int kBwdStages = K == 1 ? 2 : 1;")],
    "hgt_bwd_nocap": [("hetero_flash.cu",
                       "__launch_bounds__(kFwdThreads, kBwdBlocks<K>)",
                       "__launch_bounds__(kFwdThreads)")],
    "hgt_bwd_blocks4": [("hetero_flash.cu", _HGT_BWD_BLOCKS,
                         "constexpr int kBwdBlocks = K == 1 ? 4 : "
                         "K == 2 ? 3 : 2;")],
    "hgt_bwd_blocks6": [("hetero_flash.cu", _HGT_BWD_BLOCKS,
                         "constexpr int kBwdBlocks = K == 1 ? 6 : "
                         "K == 2 ? 3 : 2;")],
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


def cases():
    """{label: (kernel call, plain call or None, iterations)}."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    out = {}
    plan = cs.arxiv_graph(Graph).csr_plan()
    rowptr, col, _ = plan.arrays(dev)
    for F in (256, 128):
        x = torch.randn(plan.num_src, F, generator=gen).to(dev, bf)
        out[f"spmm_max_csr F={F}"] = (
            lambda x=x: k.spmm_max_csr(x, None, plan),
            lambda x=x: k.spmm_max_csr_reference(x, None, plan), 20)
        out[f"spmm_csr F={F}"] = (lambda x=x: k.spmm_csr(x, None, plan),
                                  None, 20)
        o = k.spmm_max_csr(x, None, plan)
        g = torch.randn(o.shape, generator=gen).to(dev, bf)
        out[f"segment_max_bwd F={F}"] = (
            lambda x=x, o=o, g=g: k.segment_max_bwd(x, None, o, g, plan,
                                                    False, False)[0],
            lambda x=x, o=o, g=g: k.segment_max_bwd_reference(
                x, None, o, g, plan, False, False)[0], 20)
    msg = torch.randn(plan.num_edges, 256, generator=gen).to(dev, bf)
    out["segment_max_csr F=256 per edge"] = (
        lambda: k.segment_max_csr(msg, plan),
        lambda: k.segment_max_csr_reference(msg, plan), 20)
    out["torch.segment_reduce F=256"] = (
        lambda: torch.segment_reduce(msg, "max", offsets=rowptr), None, 20)
    hub = cs.hub_plan(k, cs.SEED + 11)
    x = torch.randn(hub.num_src, 256, generator=gen).to(dev, bf)
    out["spmm_max_csr hub F=256"] = (
        lambda: k.spmm_max_csr(x, None, hub),
        lambda: k.spmm_max_csr_reference(x, None, hub), 5)
    out["spmm_csr hub F=256"] = (lambda: k.spmm_csr(x, None, hub), None, 5)
    o = k.spmm_max_csr(x, None, hub)
    g = torch.randn(o.shape, generator=gen).to(dev, bf)
    out["segment_max_bwd hub F=256"] = (
        lambda: k.segment_max_bwd(x, None, o, g, hub, False, False)[0],
        lambda: k.segment_max_bwd_reference(x, None, o, g, hub, False,
                                            False)[0], 5)
    src, dst = cs.hgt_relation()
    rel = k.build_csr_plan(src, dst, cs.HGT_PAPERS, num_src=cs.HGT_AUTHORS)
    H, D = cs.HGT_HEADS, cs.HIDDEN // cs.HGT_HEADS
    kv, q, gy = cs._hgt_inputs(gen, rel, H, D, bf, dev)
    o, m, l = k.hgt_forward(kv, q, rel)
    out["hgt_forward (4,64)"] = (
        lambda: k.hgt_forward(kv, q, rel),
        lambda: k.hgt_forward_reference(kv, q, rel), 20)
    out["hgt_backward (4,64)"] = (
        lambda: k.hgt_backward(kv, q, o, gy, m, l, rel),
        lambda: k.hgt_backward_reference(kv, q, o, gy, m, l, rel), 20)
    return out


def host_ms(fn, n=20, warmup=3):
    """Host-clock ms of fn(), each call ended by a synchronize, n after
    warmup."""
    times = []
    for i in range(n + warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def paths():
    """{path: host-clock ms of each call}."""
    from gammagl_tpu_torch.examples import common
    from gammagl_tpu_torch.models import GraphSAGEModel, HGTModel
    from gammagl_tpu_torch.serve import InferenceSession
    from gammagl_tpu_torch.train import TrainState
    from gammagl_tpu_torch.utils import load_jax_params
    dev = torch.device("cuda")
    graph = cs.arxiv_graph(Graph)
    plan = graph.csr_plan()
    x = torch.from_numpy(graph.x).to(dev)
    ei = torch.from_numpy(graph.edge_index).to(dev)
    sess = InferenceSession(cs.sage_model(GraphSAGEModel, load_jax_params),
                            (x, ei), compute_dtype=torch.bfloat16, plan=plan)
    out = {"sage_request": host_ms(lambda: sess(x, ei))}
    y, mask = cs.train_labels(x)
    state = TrainState(cs.sage_model(GraphSAGEModel, load_jax_params).to(dev),
                       cs.SAGE_LR, 0.0)
    out["sage_step"] = host_ms(lambda: common.train_step(
        state, x, ei, y, mask, plan=plan))
    hg = cs.hgt_graph(HeteroGraph)
    plans = hg.csr_plans()
    x_dict, ei_dict, _, _, _ = common.hetero_tensors(hg, "paper", dev)
    model = cs.hgt_model(HGTModel, hg).to(dev)
    out["hgt_request"] = host_ms(lambda: common.predict(
        model, x_dict, ei_dict, plan_dict=plans))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--no-paths", action="store_true",
                    help="time the kernels only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    with tempfile.TemporaryDirectory() as work:
        if args.variant:
            use_variant(args.variant, work)
        k_lib = _build.load_library()
        log = open(os.path.splitext(k_lib._name)[0] + ".log").read()
        entry = None
        for line in log.splitlines():  # the kernels' registers, spills
            if "Compiling entry" in line:
                entry = next((n for n in ("segment_max", "hgt_fwd_kernel",
                                          "hgt_bwd_kernel")
                              if n in line), None)
                name = line.split("'")[1] if entry else None
            elif entry and ("registers" in line or "spill" in line):
                print(f"  {name[:90]}: {line.strip()}")
        calls = cases()
        errs = {}
        digests = {}
        for label, (fn, plain, _) in calls.items():
            if plain is not None:
                errs[label] = err_of(fn(), plain())
                digests[label] = digest(fn())
        ms = {label: [] for label in calls}
        for _ in range(2):
            for label, (fn, _, iters) in calls.items():
                ms[label].append(cs.cuda_ms(fn, iters=iters))
        steps = {} if args.no_paths else paths()
        del k_lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for label, t in ms.items():
        err = f", max abs err {errs[label]:.3e}" if label in errs else ""
        print(f"{label}: {np.mean(t):.4f} ms ({t[0]:.4f}, {t[1]:.4f}){err}")
    for label, t in steps.items():
        print(f"{label}: median {np.median(t):.3f} ms, quartiles "
              f"{np.percentile(t, 25):.3f} / {np.percentile(t, 75):.3f} ms "
              f"over {len(t)}")
    print(smi.splitlines()[0])
    print(json.dumps({"tree": ROOT, "variant": args.variant, "card": smi,
                      "ms": {lb: float(np.mean(t)) for lb, t in ms.items()},
                      "runs": ms, "max_abs_err": errs, "digests": digests,
                      "paths_ms": {lb: float(np.median(t))
                                   for lb, t in steps.items()},
                      "path_runs": steps}))


if __name__ == "__main__":
    main()
