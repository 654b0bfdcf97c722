#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gammagl_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure ends the run with a non-zero exit:

1. Build the CUDA kernels from gammagl_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc per source started together, and print the build time and the
   compiler's register report.
2. Hold the CSR SpMM kernel against its plain PyTorch version on the card:
   bf16 and f32, F in {7, 40, 256}, a graph with empty rows and
   N_src != N_dst, a graph with no edges, a misaligned x, and the slice's
   own graph at F = 256 and F = 40; then its backward (dx through the
   kernel on the transpose plan, dw) on the slice graph at F = 256 and 40,
   bf16 and f32.
3. Hold the flash attention kernels (forward and backward) against their
   plain versions: f32 and bf16, (H, F) in {(8, 8), (1, 40), (1, 64),
   (2, 640)}, with and without a keep mask, per-edge and gathered inputs,
   empty rows with N_src != N_dst, no edges, and the slice graph at both
   GAT layers' shapes; time both kernels against the plain versions there.
4. Serve full-width GCN (ogbn-arxiv shape: 169,343 nodes, 2,315,598 edges
   plus self-loops, 128 -> 256 -> 256 -> 40, bf16) through
   `InferenceSession` with `Graph.csr_plan()`: 8 requests, each held
   against the plain COO path; exactly 3 SpMM launches a request.
5. Serve GAT on the same graph (128 -> 8 heads x 8 -> 40, bf16): 8
   requests, each held against the plain COO path within 3e-2 of max
   |logit|; exactly 2 flash forward launches a request and nothing else.
6. Train that GAT for 5 full-batch steps (drop rate 0.6, Adam lr 0.005)
   with the fusedgat twin's step, and the same model through the plain COO
   path with the same masks, generator state and parameters: step-0
   gradients of every parameter and the 5 losses held within stated
   tolerances, the loss finite and falling, and per step exactly 2 flash
   forward, 2 flash backward and 2 SpMM launches.
7. Print the card's name and power limit, one JSON line on the kernels,
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
GAT_HIDDEN, GAT_HEADS, GAT_DROP, GAT_LR = 8, 8, 0.6, 0.005
N_REQUESTS, N_STEPS = 8, 5
SEED = 0
# step-0 gradients, each parameter: max |kernel - plain| <= GRAD_TOL *
# max |plain|; losses: |kernel - plain| <= LOSS_TOL * |plain|. Both paths
# compute in bf16 and round at different points (the plain path rounds
# alpha and the messages to bf16 per edge, the kernels sum in f32).
GRAD_TOL, LOSS_TOL = 3e-2, 5e-3
FLASH_SOURCE = "gammagl_tpu_torch/csrc/flash_attention.cu"
KERNELS = {
    "spmm_csr": ("gammagl_tpu_torch/csrc/spmm_csr.cu",
                 "gammagl_tpu/ops/pallas/segment_matmul.py:243",
                 ["gammagl_tpu/ops/pallas/segment_matmul.py:774",
                  "gammagl_tpu/ops/pallas/segment_matmul.py:686"]),
    "flash_forward": (FLASH_SOURCE,
                      "gammagl_tpu/ops/pallas/flash_attention.py:566", []),
    "flash_backward": (FLASH_SOURCE,
                       "gammagl_tpu/ops/pallas/flash_attention.py:704", []),
}


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def check_close(label, got, want, rtol, atol=1e-5):
    """|got - want| <= rtol*|want| + atol*max|want|, elementwise. The
    second term covers the different f32 summation orders. Returns the
    max abs error."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: non-finite values")
    err = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    bound = rtol * want.abs() + atol * scale
    max_err = float(err.max()) if err.numel() else 0.0
    worst = float((err / bound.clamp_min(1e-30)).max()) if err.numel() else 0.
    print(f"  {label}: max_abs_err {max_err:.3e}, worst err/tol {worst:.3f} "
          f"(rtol {rtol:g} + {atol:g}*max|ref|, max|ref| {scale:.3e})")
    if not bool((err <= bound).all()):
        fail(f"{label}: kernel disagrees with the plain version")
    return max_err


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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


def paired_ms(kernel, plain, plain_iters=5):
    """plain, kernel, kernel, plain; returns the mean of each pair and the
    four runs."""
    p0 = cuda_ms(plain, iters=plain_iters)
    k0, k1 = cuda_ms(kernel), cuda_ms(kernel)
    p1 = cuda_ms(plain, iters=plain_iters)
    return (k0 + k1) / 2, (p0 + p1) / 2, (p0, k0, k1, p1)


def arxiv_graph(Graph, n_nodes=N_NODES, n_edges=N_EDGES):
    """bench.py's generator (seed 0) plus self-loops, and 128 features."""
    rng = np.random.default_rng(SEED)
    dst = (n_nodes * (rng.random(n_edges) ** 1.5)).astype(np.int64)
    src = rng.integers(0, n_nodes, n_edges)
    x = rng.normal(size=(n_nodes, N_FEAT)).astype(np.float32)
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


def gat_params():
    """A flax-shaped GATModel tree from numpy: glorot-scale ``w``,
    attention vectors large enough that the softmax is not uniform."""
    rng = np.random.default_rng(SEED + 3)
    tree = {}
    for i, (fan_in, H, F, width) in enumerate((
            (N_FEAT, GAT_HEADS, GAT_HIDDEN, GAT_HEADS * GAT_HIDDEN),
            (GAT_HEADS * GAT_HIDDEN, 1, N_CLASS, N_CLASS))):
        std = np.sqrt(2.0 / (fan_in + H * F))
        tree[f"GATConv_{i}"] = {
            "w": (rng.normal(size=(fan_in, H * F)) * std).astype(np.float32),
            "att": (rng.normal(size=(1, H, 2 * F)) * 0.3).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, width).astype(np.float32)}
    return {"params": tree}


def reset_counts(k):
    k.spmm_csr.launches = 0
    k.flash_forward.launches = 0
    k.flash_backward.launches = 0


def read_counts(k):
    return {"spmm_csr": k.spmm_csr.launches,
            "flash_forward": k.flash_forward.launches,
            "flash_backward": k.flash_backward.launches}


def phase_spmm_checks(k, slice_plan, slice_w):
    print("phase 2: CSR SpMM kernel vs plain version on the card")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    # empty rows (odd rows and the tail get no edges), N_src != N_dst
    n_dst, n_src, e = 1000, 1500, 6000
    dst = 2 * rng.integers(0, 450, e)
    src = rng.integers(0, n_src, e)
    sparse = k.build_csr_plan(src, dst, n_dst, num_src=n_src)
    empty = k.build_csr_plan(np.zeros(0, np.int64), np.zeros(0, np.int64),
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
        got = k.spmm_csr(x, w, plan)
        torch.cuda.synchronize()
        check_close(label, got, k.spmm_csr_reference(x, w, plan), rtol)

    main_err, timings = 0.0, {}
    for F in (HIDDEN, N_CLASS):
        x = torch.randn(slice_plan.num_src, F, generator=g).to(
            dev, torch.bfloat16)
        got = k.spmm_csr(x, slice_w, slice_plan, weights_padded=True)
        torch.cuda.synchronize()
        want = k.spmm_csr_reference(x, slice_w, slice_plan,
                                    weights_padded=True)
        err = check_close(f"slice graph bf16 F={F}", got, want, 1e-2)
        main_err = max(main_err, err)
        k_ms, p_ms, runs = paired_ms(
            lambda: k.spmm_csr(x, slice_w, slice_plan, weights_padded=True),
            lambda: k.spmm_csr_reference(x, slice_w, slice_plan,
                                         weights_padded=True))
        gb = slice_plan.num_edges * F * 2 / 1e9
        print(f"  F={F} bf16: kernel {k_ms:.4f} ms ({runs[1]:.4f}, "
              f"{runs[2]:.4f}), plain {p_ms:.4f} ms ({runs[0]:.4f}, "
              f"{runs[3]:.4f}); gather {gb:.3f} GB -> "
              f"{gb / (k_ms / 1e3):.1f} GB/s, "
              f"{slice_plan.num_edges / (k_ms / 1e3) / 1e9:.3f} G edges/s")
        timings[F] = {"F": F, "ms": k_ms, "plain_ms": p_ms,
                      "max_abs_err": err}

    # the backward: dx is the kernel on the transpose plan, dw a rowdot;
    # the plain dx is the plain SpMM on the same transpose plan
    tp = slice_plan.transpose()
    w_t = slice_w[tp.arrays(dev)[2]]
    rowptr, col, _ = slice_plan.arrays(dev)
    rows = torch.repeat_interleave(
        torch.arange(slice_plan.num_nodes, device=dev), rowptr.diff(),
        output_size=slice_plan.num_edges)
    for F in (HIDDEN, N_CLASS):
        for dtype, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            x = torch.randn(slice_plan.num_src, F, generator=g).to(
                dev, dtype).requires_grad_()
            w = slice_w.clone().requires_grad_()
            gy = torch.randn(slice_plan.num_nodes, F, generator=g).to(
                dev, dtype)
            k.spmm_csr(x, w, slice_plan, weights_padded=True).backward(gy)
            torch.cuda.synchronize()
            want_dx = k.spmm_csr_reference(gy, w_t, tp, weights_padded=True)
            want_dw = (x.detach()[col.long()].float()
                       * gy[rows].float()).sum(1)
            main_err = max(main_err, check_close(
                f"backward dx {dtype} F={F}", x.grad, want_dx, rtol))
            check_close(f"backward dw {dtype} F={F}", w.grad, want_dw, 1e-5)
    return main_err, timings


def _flash_inputs(gen, plan, H, F, dtype, gather, keep, dev):
    rows = plan.num_src if gather else plan.num_edges
    s = torch.randn(rows, H, generator=gen).to(dev)
    a = torch.randn(plan.num_nodes, H, generator=gen).to(dev)
    msg = torch.randn(rows, H * F, generator=gen).to(dev, dtype)
    kp = None
    if keep:
        kp = ((torch.rand(plan.num_edges, H, generator=gen) < 1 - GAT_DROP)
              .float() / (1 - GAT_DROP)).to(dev)
    return s, a, msg, kp


def flash_check(k, label, plan, H, F, dtype, gather, keep, gen, dev,
                repeat=False):
    """Forward and backward kernels against the plain versions; returns
    the max abs error of each: {"flash_forward": over out and l,
    "flash_backward": over ds, dmsg and da}. With ``gather`` keep is in
    the caller's edge order, read through the plan's perm."""
    s, a, msg, kp = _flash_inputs(gen, plan, H, F, dtype, gather, keep, dev)
    out, m, l = k.flash_forward(s, a, msg, kp, plan, 0.2, gather)
    g = torch.randn(out.shape, generator=gen).to(dev, dtype)
    ds, dmsg, da = k.flash_backward(s, a, msg, kp, m, l, out, g, plan, 0.2,
                                    gather)
    torch.cuda.synchronize()
    r_out, r_m, r_l = k.flash_forward_reference(s, a, msg, kp, plan, 0.2,
                                                gather)
    r_ds, r_dmsg, r_da = k.flash_backward_reference(
        s, a, msg, kp, r_m, r_l, out, g, plan, 0.2, gather)
    rt = 1e-2 if dtype == torch.bfloat16 else 1e-5
    if not torch.equal(m, r_m):  # the same f32 scores, the same max
        fail(f"{label} m: row maxima differ")
    err = {"flash_forward": 0.0, "flash_backward": 0.0}
    for kname, name, got, want, rtol in (
            ("flash_forward", "out", out, r_out, rt),
            ("flash_forward", "l", l, r_l, 1e-5),
            ("flash_backward", "ds", ds, r_ds, 1e-5),
            ("flash_backward", "dmsg", dmsg, r_dmsg, rt),
            ("flash_backward", "da", da, r_da, 1e-5)):
        err[kname] = max(err[kname],
                         check_close(f"{label} {name}", got, want, rtol))
    if repeat:  # no atomics: a second run gives the same bits
        out2 = k.flash_forward(s, a, msg, kp, plan, 0.2, gather)[0]
        ds2 = k.flash_backward(s, a, msg, kp, m, l, out, g, plan, 0.2,
                               gather)[0]
        if not (torch.equal(out, out2) and torch.equal(ds, ds2)):
            fail(f"{label}: repeated launches differ")
    return err


def phase_flash_checks(k, slice_plan):
    print("phase 3: flash attention kernels vs plain versions on the card")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    rng = np.random.default_rng(SEED + 4)
    n_dst, n_src, e = 700, 900, 5000
    dst = 2 * rng.integers(0, 300, e)  # odd rows and the tail: empty
    plan = k.build_csr_plan(rng.integers(0, n_src, e), dst, n_dst,
                            num_src=n_src)
    none = np.zeros(0, np.int64)
    empty = k.build_csr_plan(none, none, 50, num_src=30)
    for dtype in (torch.float32, torch.bfloat16):
        for H, F in ((8, 8), (1, 40), (1, 64), (2, 640)):
            # (keep, gather): no keep; keep in CSR order with per-edge
            # inputs; keep in the caller's order with node rows
            for keep, gather in ((False, True), (True, False), (True, True)):
                flash_check(k, f"{dtype} H={H} F={F} keep={keep} "
                            f"gather={gather}", plan, H, F, dtype, gather,
                            keep, gen, dev, repeat=keep)
            flash_check(k, f"{dtype} H={H} F={F} E=0", empty, H, F, dtype,
                        True, True, gen, dev)
    main_err = {"flash_forward": 0.0, "flash_backward": 0.0}
    timings = {"flash_forward": [], "flash_backward": []}
    for H, F in ((GAT_HEADS, GAT_HIDDEN), (1, N_CLASS)):
        label = f"slice graph bf16 H={H} F={F}"
        err = flash_check(k, label, slice_plan, H, F, torch.bfloat16, True,
                          True, gen, dev)
        for name in main_err:
            main_err[name] = max(main_err[name], err[name])
        s, a, msg, kp = _flash_inputs(gen, slice_plan, H, F, torch.bfloat16,
                                      True, True, dev)
        # as GATConv calls them: node rows, keep in the caller's order
        args = (s, a, msg, kp)
        out, m, l = k.flash_forward(*args, slice_plan, 0.2, True)
        g = torch.randn(out.shape, generator=gen).to(dev, torch.bfloat16)
        bwd_args = (*args, m, l, out, g, slice_plan, 0.2, True)
        for name, kern, plain in (
                ("flash_forward",
                 lambda: k.flash_forward(*args, slice_plan, 0.2, True),
                 lambda: k.flash_forward_reference(*args, slice_plan, 0.2,
                                                   True)),
                ("flash_backward",
                 lambda: k.flash_backward(*bwd_args),
                 lambda: k.flash_backward_reference(*bwd_args))):
            k_ms, p_ms, runs = paired_ms(kern, plain, plain_iters=3)
            # bytes the kernel must move at least: each edge's gathered
            # message row, score and keep, its col and keep row index
            # (and, backward, its dmsg row and ds)
            per_edge = H * F * 2 + 4 * H + 4 * H + 4 + 8
            if name == "flash_backward":
                per_edge += H * F * 2 + 4 * H
            gb = slice_plan.num_edges * per_edge / 1e9
            print(f"  {name} H={H} F={F}: kernel {k_ms:.4f} ms "
                  f"({runs[1]:.4f}, {runs[2]:.4f}), plain {p_ms:.4f} ms "
                  f"({runs[0]:.4f}, {runs[3]:.4f}); per-edge bytes "
                  f"{gb:.3f} GB -> {gb / (k_ms / 1e3):.1f} GB/s")
            timings[name].append({"H": H, "F": F, "ms": k_ms,
                                  "plain_ms": p_ms, "per_edge_gb": gb})
    return main_err, timings


def phase_gcn_serve(k, GCNModel, InferenceSession, load_jax_params, plan, x,
                    ei):
    print("phase 4: serve GCN through InferenceSession")
    model = GCNModel(hidden_dim=HIDDEN, num_class=N_CLASS,
                     num_layers=N_LAYERS, drop_rate=0.5,
                     dtype=torch.bfloat16)
    load_jax_params(model, random_params())
    sess = InferenceSession(model, (x, ei), device="cuda",
                            compute_dtype=torch.bfloat16, plan=plan)
    return serve(k, sess, x, ei, {"spmm_csr": N_LAYERS}, "GCN")


def serve(k, sess, x, ei, per_request, name):
    """Drive N_REQUESTS requests with counts reset just before; hold each
    against the plain COO path. Returns (counts, latencies in ms)."""
    requests = [x + r * 1e-3 for r in range(N_REQUESTS)]
    sync()
    reset_counts(k)
    outputs, lat_ms = [], []
    for xr in requests:
        t0 = time.perf_counter()
        out = sess(xr, ei)
        sync()
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append(out)
    counts = read_counts(k)
    want = {kname: per_request.get(kname, 0) * N_REQUESTS
            for kname in counts}
    print(f"  {N_REQUESTS} {name} requests, launches {counts}")
    if counts != want:
        fail(f"{name} serve: expected launches {want}, counted {counts}")
    with torch.inference_mode():
        for r, (xr, out) in enumerate(zip(requests, outputs)):
            if out.shape != (x.shape[0], N_CLASS):
                fail(f"{name} request {r}: logits shape {tuple(out.shape)}")
            ref = sess.model(xr.to(torch.bfloat16), ei)  # plain COO path
            err = float((out.float() - ref.float()).abs().max())
            tol = 3e-2 * float(ref.float().abs().max())
            print(f"  request {r}: {lat_ms[r]:.3f} ms, max |logit - plain| "
                  f"{err:.3e} (tol {tol:.3e})")
            if not (bool(torch.isfinite(out).all()) and err <= tol):
                fail(f"{name} request {r}: logits disagree with the plain "
                     "path")
    lat = np.asarray(lat_ms)
    print(f"  {name} request latency: p50 {np.median(lat):.3f} ms, "
          f"max {lat.max():.3f} ms")
    return counts, lat


def gat_model(GATModel, load_jax_params):
    model = GATModel(hidden_dim=GAT_HIDDEN, num_class=N_CLASS,
                     heads=GAT_HEADS, drop_rate=GAT_DROP,
                     dtype=torch.bfloat16, in_channels=N_FEAT)
    return load_jax_params(model, gat_params())


def phase_gat_serve(k, GATModel, InferenceSession, load_jax_params, plan, x,
                    ei):
    print("phase 5: serve GAT through InferenceSession")
    sess = InferenceSession(gat_model(GATModel, load_jax_params), (x, ei),
                            device=x.device, compute_dtype=torch.bfloat16,
                            plan=plan)
    return serve(k, sess, x, ei, {"flash_forward": 2}, "GAT")


def phase_gat_train(k, twin, GATModel, TrainState, load_jax_params, plan, x,
                    ei):
    """5 steps through the kernels and through the plain COO path, with
    the same keep masks, input-dropout generator state and parameters."""
    print("phase 6: train GAT (the fusedgat twin's step) against the plain "
          "path")
    dev = x.device
    n, E = x.shape[0], ei.shape[1]
    rng = np.random.default_rng(SEED + 5)
    y = torch.from_numpy(rng.integers(0, N_CLASS, n)).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.54).to(dev)
    states = {}
    for path in ("kernel", "plain"):
        model = gat_model(GATModel, load_jax_params).to(dev)
        states[path] = TrainState(model, GAT_LR)
    keep_gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    per_step = {"spmm_csr": 2, "flash_forward": 2, "flash_backward": 2}
    losses = {"kernel": [], "plain": []}
    step_ms = {"kernel": [], "plain": []}
    launches = {kname: 0 for kname in per_step}
    grad_err = 0.0
    for step in range(N_STEPS):
        keeps = [k.attention_keep_mask(keep_gen, GAT_DROP, (E, h), dev)
                 for h in (GAT_HEADS, 1)]
        for path in ("kernel", "plain"):
            state = states[path]
            gen = torch.Generator(device=dev).manual_seed(SEED + 100 + step)
            kw = dict(plan=plan if path == "kernel" else None, keeps=keeps,
                      generator=gen)
            sync()
            reset_counts(k)
            t0 = time.perf_counter()
            if step == 0:  # read the gradients before the update
                state.model.train()
                loss = twin.loss_and_grad(state.model, x, ei, y, mask, **kw)
                grads = {name: p.grad.clone()
                         for name, p in state.model.named_parameters()}
                state.apply_gradients()
            else:
                loss = twin.train_step(state, x, ei, y, mask, **kw)
            loss = float(loss)
            sync()
            step_ms[path].append((time.perf_counter() - t0) * 1e3)
            counts = read_counts(k)
            if path == "kernel":
                if counts != per_step:
                    fail(f"train step {step}: expected launches {per_step}, "
                         f"counted {counts}")
                for kname in launches:
                    launches[kname] += counts[kname]
                if step == 0:
                    kernel_grads = grads
            elif any(counts.values()):
                fail(f"the plain path launched kernels: {counts}")
            losses[path].append(loss)
        if step == 0:
            for name, want in grads.items():
                grad_err = max(grad_err, check_close(
                    f"step-0 grad {name}", kernel_grads[name], want, 0.0,
                    atol=GRAD_TOL))
        lk, lp = losses["kernel"][-1], losses["plain"][-1]
        print(f"  step {step}: loss kernel {lk:.5f}, plain {lp:.5f}; "
              f"{step_ms['kernel'][-1]:.2f} ms kernel path, "
              f"{step_ms['plain'][-1]:.2f} ms plain path")
        if not np.isfinite(lk) or abs(lk - lp) > LOSS_TOL * abs(lp):
            fail(f"step {step}: loss {lk} vs plain {lp}")
    if not losses["kernel"][-1] < losses["kernel"][0]:
        fail(f"loss did not fall: {losses['kernel']}")
    ms = np.asarray(step_ms["kernel"][1:])
    print(f"  train step (steps 1-{N_STEPS - 1}): median {np.median(ms):.2f}"
          f" ms kernel path, {np.median(step_ms['plain'][1:]):.2f} ms plain "
          f"path; launches {launches}")
    return launches, losses, step_ms, grad_err


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this smoke run needs the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gammagl_tpu_torch.data import Graph
    from gammagl_tpu_torch.examples import fusedgat_trainer as twin
    from gammagl_tpu_torch.models import GATModel, GCNModel
    from gammagl_tpu_torch.ops import cuda as k
    from gammagl_tpu_torch.ops.cuda._build import load_library
    from gammagl_tpu_torch.serve import InferenceSession
    from gammagl_tpu_torch.train import TrainState
    from gammagl_tpu_torch.utils import load_jax_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
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
    # the first GCN layer's normalised edge weights, in CSR order
    deg = torch.bincount(ei[1], minlength=N_NODES).float()
    deg_src = torch.bincount(ei[0], minlength=N_NODES).float()
    w = deg_src.rsqrt()[ei[0]] * deg.rsqrt()[ei[1]]
    spmm_err, spmm_ms = phase_spmm_checks(k, plan,
                                          k.pad_edge_weights(plan, w))
    flash_err, flash_ms = phase_flash_checks(k, plan)
    gcn_counts, gcn_lat = phase_gcn_serve(k, GCNModel, InferenceSession,
                                          load_jax_params, plan, x, ei)
    gat_counts, gat_lat = phase_gat_serve(k, GATModel, InferenceSession,
                                          load_jax_params, plan, x, ei)
    train_counts, losses, step_ms, grad_err = phase_gat_train(
        k, twin, GATModel, TrainState, load_jax_params, plan, x, ei)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if "jax" in sys.modules or "gammagl_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    print(f"  whole run {time.perf_counter() - t_start:.1f} s")
    print(smi.splitlines()[0])
    runs = {"gcn_serve": gcn_counts, "gat_serve": gat_counts,
            "gat_train": train_counts}
    entries = []
    for name, (source, replaces, also) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(c[name] for c in runs.values()),
                 "launches_by_path": {p: c[name] for p, c in runs.items()}}
        if also:
            entry["also_replaces"] = also
        if name == "spmm_csr":
            entry.update(max_abs_err=spmm_err, ms=spmm_ms[HIDDEN]["ms"],
                         plain_ms=spmm_ms[HIDDEN]["plain_ms"],
                         by_width=[spmm_ms[HIDDEN], spmm_ms[N_CLASS]])
        else:
            entry.update(max_abs_err=flash_err[name],
                         ms=flash_ms[name][0]["ms"],
                         plain_ms=flash_ms[name][0]["plain_ms"],
                         by_shape=flash_ms[name])
        entries.append(entry)
    print(json.dumps({
        "kernels": entries,
        "gcn_request_p50_ms": float(np.median(gcn_lat)),
        "gcn_request_max_ms": float(gcn_lat.max()),
        "gat_request_p50_ms": float(np.median(gat_lat)),
        "gat_request_max_ms": float(gat_lat.max()),
        "gat_train_step_ms": float(np.median(step_ms["kernel"][1:])),
        "gat_train_step_plain_ms": float(np.median(step_ms["plain"][1:])),
        "gat_train_losses": losses["kernel"],
        "gat_step0_grad_max_abs_err": grad_err}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
