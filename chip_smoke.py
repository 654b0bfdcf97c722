#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gammagl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure ends the run with a non-zero exit:

1. Build the CUDA kernels from gammagl_tpu_torch/csrc/ with nvcc (sm_90a)
   and print the build time and the compiler's register report.
2. Hold the CSR SpMM kernel against its plain PyTorch version on the card:
   bf16 and f32, F in {7, 40, 256}, a graph with empty rows and
   N_src != N_dst, a graph with no edges, a misaligned x, and the slice's
   own graph at F = 256 and F = 40.
3. Serve full-width GCN (ogbn-arxiv shape: 169,343 nodes, 2,315,598 edges
   plus self-loops, 128 -> 256 -> 256 -> 40, bf16) through
   `InferenceSession` with `Graph.csr_plan()`: 8 requests, each with its
   own features, each held against the same model run with the plain COO
   SpMM on the card; the kernel must have been launched 3 times a request.
   Time the requests, and the kernel against the plain version at F = 256
   and F = 40.
4. Print the card's name and power limit, one JSON line on the kernels,
   and as the last line {"ok": true, "device": {...}}.

It needs a CUDA card and the repository beside it; it imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_NODES, N_EDGES, N_FEAT = 169_343, 2_315_598, 128
HIDDEN, N_CLASS, N_LAYERS = 256, 40, 3
N_REQUESTS = 8
SEED = 0
SOURCE = "gammagl_tpu_torch/csrc/spmm_csr.cu"
REPLACES = "gammagl_tpu/ops/pallas/segment_matmul.py:243"
ALSO_REPLACES = ["gammagl_tpu/ops/pallas/segment_matmul.py:774",
                 "gammagl_tpu/ops/pallas/segment_matmul.py:686"]


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(label, got, want, rtol):
    """|got - want| <= rtol*|want| + 1e-5*max|want|, elementwise. The
    second term covers the different f32 summation orders. Returns the
    max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    bound = rtol * want.abs() + 1e-5 * scale
    max_err = float(err.max()) if err.numel() else 0.0
    worst = float((err / bound.clamp_min(1e-30)).max()) if err.numel() else 0.
    print(f"  {label}: max_abs_err {max_err:.3e}, worst err/tol {worst:.3f} "
          f"(rtol {rtol:g} + 1e-5*max|ref|, max|ref| {scale:.3e})")
    if not bool((err <= bound).all()):
        fail(f"{label}: kernel disagrees with the plain version")
    return max_err


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms over `iters` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def arxiv_graph(Graph):
    """bench.py's generator (seed 0) plus self-loops, and 128 features."""
    rng = np.random.default_rng(SEED)
    dst = (N_NODES * (rng.random(N_EDGES) ** 1.5)).astype(np.int64)
    src = rng.integers(0, N_NODES, N_EDGES)
    x = rng.normal(size=(N_NODES, N_FEAT)).astype(np.float32)
    return Graph(x=x, edge_index=np.stack([src, dst])).add_self_loop()


def random_params():
    """A flax-shaped GCNModel tree from numpy: glorot kernels, small bias."""
    rng = np.random.default_rng(SEED + 1)
    dims = [N_FEAT] + [HIDDEN] * (N_LAYERS - 1) + [N_CLASS]
    tree = {}
    for i in range(N_LAYERS):
        lim = np.sqrt(6.0 / (dims[i] + dims[i + 1]))
        tree[f"GCNConv_{i}"] = {
            "Dense_0": {"kernel": rng.uniform(
                -lim, lim, (dims[i], dims[i + 1])).astype(np.float32)},
            "bias": rng.uniform(-0.1, 0.1, dims[i + 1]).astype(np.float32)}
    return {"params": tree}


def phase_kernel_checks(ops, slice_plan, slice_w):
    print("phase 2: kernel vs plain version on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    # empty rows (odd rows and the tail get no edges), N_src != N_dst
    n_dst, n_src, e = 1000, 1500, 6000
    dst = 2 * rng.integers(0, 450, e)
    src = rng.integers(0, n_src, e)
    sparse = ops.build_csr_plan(src, dst, n_dst, num_src=n_src)
    empty = ops.build_csr_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               50, num_src=30)
    cases = []
    for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for F in (7, 40, 256):
            w = torch.rand(e, generator=g).to(dev)
            x = torch.randn(n_src, F, generator=g).to(dev, dtype)
            cases.append((f"{dtype} F={F} empty rows", x, w, sparse, rtol))
            cases.append((f"{dtype} F={F} empty rows, unit w", x, None,
                          sparse, rtol))
            cases.append((f"{dtype} F={F} E=0",
                          torch.randn(30, F, generator=g).to(dev, dtype),
                          torch.zeros(0, device=dev), empty, rtol))
        flat = torch.randn(n_src * 256 + 1, generator=g).to(dev, dtype)
        cases.append((f"{dtype} F=256 misaligned x",
                      flat[1:].view(n_src, 256), w, sparse, rtol))
    for label, x, w, plan, rtol in cases:
        got = ops.spmm_csr(x, w, plan)
        torch.cuda.synchronize()
        check_close(label, got, ops.spmm_csr_reference(x, w, plan), rtol)

    main_err, timings = 0.0, {}
    for F in (HIDDEN, N_CLASS):
        x = torch.randn(slice_plan.num_src, F, generator=g).to(
            dev, torch.bfloat16)
        got = ops.spmm_csr(x, slice_w, slice_plan, weights_padded=True)
        torch.cuda.synchronize()
        want = ops.spmm_csr_reference(x, slice_w, slice_plan,
                                      weights_padded=True)
        err = check_close(f"slice graph bf16 F={F}", got, want, 1e-2)
        main_err = max(main_err, err)
        # plain, kernel, kernel, plain: report the mean of each pair
        p0 = cuda_ms(lambda: ops.spmm_csr_reference(
            x, slice_w, slice_plan, weights_padded=True), iters=5)
        k0 = cuda_ms(lambda: ops.spmm_csr(x, slice_w, slice_plan,
                                          weights_padded=True))
        k1 = cuda_ms(lambda: ops.spmm_csr(x, slice_w, slice_plan,
                                          weights_padded=True))
        p1 = cuda_ms(lambda: ops.spmm_csr_reference(
            x, slice_w, slice_plan, weights_padded=True), iters=5)
        k_ms, p_ms = (k0 + k1) / 2, (p0 + p1) / 2
        gb = slice_plan.num_edges * F * 2 / 1e9
        print(f"  F={F} bf16: kernel {k_ms:.4f} ms ({k0:.4f}, {k1:.4f}), "
              f"plain {p_ms:.4f} ms ({p0:.4f}, {p1:.4f}); "
              f"gather {gb:.3f} GB -> {gb / (k_ms / 1e3):.1f} GB/s, "
              f"{slice_plan.num_edges / (k_ms / 1e3) / 1e9:.3f} G edges/s")
        timings[F] = {"F": F, "ms": k_ms, "plain_ms": p_ms,
                      "max_abs_err": err}
    return main_err, timings


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke run needs the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gammagl_tpu_torch import ops
    from gammagl_tpu_torch.data import Graph
    from gammagl_tpu_torch.models import GCNModel
    from gammagl_tpu_torch.ops.cuda._build import load_library
    from gammagl_tpu_torch.serve import InferenceSession
    from gammagl_tpu_torch.utils import load_jax_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    print("phase 1: build")
    t0 = time.perf_counter()
    lib = load_library()
    print(f"  kernel library ready in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.relpath(lib._name)}")
    log = os.path.splitext(lib._name)[0] + ".log"
    for line in open(log).read().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())

    t0 = time.perf_counter()
    graph = arxiv_graph(Graph)
    plan = graph.csr_plan()
    print(f"  graph: {graph.num_nodes} nodes, {graph.num_edges} edges with "
          f"self-loops, CSR plan in {time.perf_counter() - t0:.2f} s")
    if (graph.num_nodes, graph.num_edges) != (N_NODES, N_EDGES + N_NODES):
        fail("slice graph has the wrong size")
    x = torch.from_numpy(graph.x).to(dev)
    ei = torch.from_numpy(graph.edge_index).to(dev)
    # the first layer's normalised edge weights, in CSR order
    deg = torch.bincount(ei[1], minlength=N_NODES).float()
    deg_src = torch.bincount(ei[0], minlength=N_NODES).float()
    w = deg_src.rsqrt()[ei[0]] * deg.rsqrt()[ei[1]]
    main_err, timings = phase_kernel_checks(
        ops, plan, ops.pad_edge_weights(plan, w))

    print("phase 3: serve GCN through InferenceSession")
    model = GCNModel(hidden_dim=HIDDEN, num_class=N_CLASS,
                     num_layers=N_LAYERS, drop_rate=0.5,
                     dtype=torch.bfloat16)
    load_jax_params(model, random_params())
    t0 = time.perf_counter()
    sess = InferenceSession(model, (x, ei), device="cuda",
                            compute_dtype=torch.bfloat16, plan=plan)
    torch.cuda.synchronize()
    print(f"  session built (warm-up call included) in "
          f"{time.perf_counter() - t0:.2f} s")
    requests = [x + r * 1e-3 for r in range(N_REQUESTS)]
    torch.cuda.synchronize()

    ops.spmm_csr.launches = 0
    outputs, lat_ms = [], []
    for xr in requests:
        t0 = time.perf_counter()
        out = sess(xr, ei)
        torch.cuda.synchronize()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append(out)
    launches = ops.spmm_csr.launches
    print(f"  {N_REQUESTS} requests, {launches} kernel launches")
    if launches != N_LAYERS * N_REQUESTS:
        fail(f"expected {N_LAYERS * N_REQUESTS} kernel launches on the "
             f"main path, counted {launches}")

    with torch.inference_mode():
        for r, (xr, out) in enumerate(zip(requests, outputs)):
            if out.shape != (N_NODES, N_CLASS):
                fail(f"request {r}: logits shape {tuple(out.shape)}")
            ref = sess.model(xr.to(torch.bfloat16), ei)  # plain COO SpMM
            err = float((out.float() - ref.float()).abs().max())
            tol = 3e-2 * float(ref.float().abs().max())
            print(f"  request {r}: {lat_ms[r]:.3f} ms, max |logit - plain| "
                  f"{err:.3e} (tol {tol:.3e})")
            if not (bool(torch.isfinite(out).all()) and err <= tol):
                fail(f"request {r}: logits disagree with the plain path")
    lat = np.asarray(lat_ms)
    print(f"  request latency: p50 {np.median(lat):.3f} ms, "
          f"max {lat.max():.3f} ms")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if "jax" in sys.modules or "gammagl_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    print(smi.splitlines()[0])
    print(json.dumps({"kernels": [{
        "name": "spmm_csr", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": launches, "max_abs_err": main_err,
        "ms": timings[HIDDEN]["ms"], "plain_ms": timings[HIDDEN]["plain_ms"],
        "by_width": [timings[HIDDEN], timings[N_CLASS]],
        "request_p50_ms": float(np.median(lat)),
        "request_max_ms": float(lat.max())}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
