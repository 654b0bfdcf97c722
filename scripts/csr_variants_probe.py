#!/usr/bin/env python3
"""Time variants of the port's CSR kernel (csrc/spmm_csr.cu) on one card.

    python3 scripts/csr_variants_probe.py [--variants ca8,cg8,ca4,cg4]

A variant names the copy form of the kernel's ring of gathered rows (``ca``:
cp.async through L1, ``cg``: past L1) and its depth (stages a lane). Each is
compiled from the source with ``kStages`` and the 16-byte copy replaced, and
loaded as its own library in this one process, so all run on the same card
in turns (the order reversed in the second round). The shapes are those of
chip_smoke.py's phases 2, 4, 18 and 24: the arxiv-shape graph (SpMM at
F = 256 and 40, the per-edge segment sum at C = 64 and 40), the RCM-ordered
banded graph (SpMM at F = 256 and 40), and the papers shard at 1% (the
one-plan forward and transpose at F = 256, `spmm_csr_acc` on interior block
1 at F = 128 and 256), all bf16. Each variant's outputs are checked bitwise
against the first's. Needs nvcc and a CUDA card; imports no JAX.
"""

import argparse
import ctypes
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
from gammagl_tpu_torch.ops.cuda import segment_matmul as sm  # noqa: E402

COPY = "cp.async.ca.shared.global [%0], [%1], %2;"
STAGES = "constexpr int kStages = 8;"


def build(names, work):
    """{variant: its library}, compiled in parallel."""
    src = open(_build.CSRC_DIR / "spmm_csr.cu").read()
    common = open(_build.CSRC_DIR / "common.cuh").read()
    if COPY not in common or STAGES not in src:
        raise RuntimeError("spmm_csr.cu or common.cuh no longer has the "
                           "lines this probe rewrites")
    nvcc, procs = _build._find_nvcc(), {}
    for name in names:
        op, stages = name[:2], int(name[2:])
        variant = src.replace(STAGES, f"constexpr int kStages = {stages};")
        header = common
        if op == "cg":  # the 16-byte copy past L1; narrower ones stay .ca
            header = header.replace(
                "  if constexpr (kBytes >= 4) {",
                "  if constexpr (kBytes == 16) {\n    asm volatile(\"cp.async.cg"
                ".shared.global [%0], [%1], 16;\\n\" ::\"r\"(d), \"l\"(src) : "
                "\"memory\");\n  } else if constexpr (kBytes >= 4) {", 1)
        d = os.path.join(work, name)
        os.makedirs(d)
        open(os.path.join(d, "spmm_csr.cu"), "w").write(variant)
        open(os.path.join(d, "common.cuh"), "w").write(header)
        shutil.copy(_build.CSRC_DIR / "csr_items.cuh", d)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "spmm_csr.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        libs[name] = ctypes.CDLL(os.path.join(work, name, "lib.so"))
    return libs


def use(lib):
    """Route the wrappers of ops.cuda.segment_matmul to ``lib``."""
    sm.load_library = lambda: lib
    for fn in (sm._kernel, sm._acc_kernel, sm._fold_kernel):
        fn.cache_clear()


def cases():
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    out = {}
    for name, graph in (("arxiv", cs.arxiv_graph(Graph)),
                        ("banded", cs.banded_graph(Graph).reorder_rcm()[0])):
        plan = graph.csr_plan()
        ei = torch.from_numpy(graph.edge_index).to(dev)
        w = k.pad_edge_weights(plan, cs.gcn_weights(ei, cs.N_NODES))
        for F in (256, 40):
            x = torch.randn(plan.num_src, F, generator=g).to(dev, bf)
            out[f"{name} spmm_csr F={F}"] = (
                lambda x=x, w=w, plan=plan: k.spmm_csr(
                    x, w, plan, weights_padded=True))
        if name == "arxiv":
            for C in (64, 40):
                v = torch.randn(plan.num_edges, C, generator=g).to(dev, bf)
                out[f"arxiv segment_sum_csr C={C}"] = (
                    lambda v=v, plan=plan: k.segment_sum_csr(v, plan))
    shard = cs.papers_shard(k)
    part, N = shard["part"], shard["part"].rows_per
    one = k.build_csr_plan(shard["ei"][0], shard["ei"][1], N, num_src=N)
    w1 = torch.from_numpy(shard["w"][one.perm]).to(dev)
    tp = one.transpose()
    wt = w1[tp.arrays(dev)[2]]
    x = torch.randn(N, 256, generator=g).to(dev, bf)
    out["papers one-plan forward F=256"] = lambda: k.spmm_csr(
        x, w1, one, weights_padded=True)
    out["papers one-plan transpose F=256"] = lambda: k.spmm_csr(
        x, wt, tp, weights_padded=True)
    (lo, hi), blk = part.src_spans[1], part.interior[1][0]
    wb = torch.from_numpy(part.interior_w[1][0]).to(dev)
    for F in (128, 256):
        xb = torch.randn(hi - lo, F, generator=g).to(dev, bf)
        prev = torch.randn(N, F, generator=g).to(dev, bf)
        out[f"papers spmm_csr_acc block 1 F={F}"] = (
            lambda xb=xb, prev=prev: k.spmm_csr_acc(
                xb, wb, blk, prev=prev, weights_padded=True))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="ca8,cg8,ca4,cg4")
    names = ap.parse_args().variants.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    with tempfile.TemporaryDirectory() as work:
        libs = build(names, work)
        calls = cases()
        first = {}
        for name in names:
            use(libs[name])
            for label, fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if label not in first:
                    first[label] = got
                elif not torch.equal(got, first[label]):
                    raise SystemExit(f"{name} {label}: differs from "
                                     f"{names[0]}")
        ms = {label: {name: [] for name in names} for label in calls}
        for order in (names, names[::-1]):
            for name in order:
                use(libs[name])
                for label, fn in calls.items():
                    ms[label][name].append(cs.cuda_ms(fn))
    for label, row in ms.items():
        print(f"{label}: " + ", ".join(
            f"{n} {np.mean(t):.4f} ({t[0]:.4f}, {t[1]:.4f})"
            for n, t in row.items()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
