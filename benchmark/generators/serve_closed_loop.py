"""Requests from one caller in a closed loop: the next request is sent
when the previous answer is on the host.

Each request brings its own input (the model file's ``features(i)``, made
on the device from the seed and the request index before the request is
due, untimed). Its latency runs from the call to the answer on the host:
the argmax class of every row, copied back. Set-up builds the server and
sends ``warm_requests`` requests of the same shapes.

After the window (and the trace, with ``--trace 1``), the peak memory is
read and the server freed; then ``sampled_requests`` of the window's
requests, drawn from the seed, are computed again by the reference, and
each answer is judged by the gap of its class's reference logit below
the reference's best.
"""

import math
import random
import time

import torch

from harness import compare, env


def _plant(ctx, answer):
    """Faults that a test or a calibration run plants where an answer is
    produced: ``altered``: one row's class changed; ``half_batch``: half
    the rows left out."""
    if ctx.plant == "altered":
        answer = answer.clone()
        answer[0] = (answer[0] + 1) % ctx.cfg["num_classes"]
        return answer
    if ctx.plant == "half_batch":
        return answer[: answer.shape[0] // 2]
    if ctx.plant:
        raise ValueError(f"unknown fault {ctx.plant}")
    return answer


def _sample(ctx, done):
    rng = random.Random(ctx.seed)
    k = min(ctx.traffic["sampled_requests"], len(done))
    return sorted(rng.sample(done, k))


def run(ctx):
    if ctx.control:
        inputs = ctx.model.make_inputs(ctx.cfg, ctx.seed, ctx.device)
        ctx.phases.mark("graph")
        gap = 0.0
        for i in range(ctx.traffic["sampled_requests"]):
            x = ctx.model.request_features(ctx.cfg, ctx.seed, i,
                                           inputs["counts"], ctx.device)
            low = ctx.reference.forward(ctx.cfg, inputs, x, rnd=compare.fp8)
            ref = ctx.reference.forward(ctx.cfg, inputs, x)
            gap = max(gap, compare.served_gap(low.argmax(1), ref))
            del low, ref
        return {"numbers": {"served_gap": gap},
                "setup_s": ctx.phases.since_start(),
                "attempted": ctx.traffic["sampled_requests"], "failed": 0}

    server = ctx.model.build_server(ctx.cfg, ctx.seed, ctx.device,
                                    ctx.phases)
    for i in range(ctx.traffic["warm_requests"]):
        server.request(server.features(-1 - i)).argmax(1).cpu()
    env.sync(ctx.device)
    ctx.phases.mark(f"warm-up ({ctx.traffic['warm_requests']} requests)")
    setup_s = ctx.phases.since_start()

    answers, lat, host = {}, [], []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < ctx.seconds:
        x = server.features(i)
        env.sync(ctx.device)
        t = time.perf_counter()
        logits = server.request(x)
        host.append(time.perf_counter() - t)
        answer = logits.argmax(1).to(torch.int16).cpu()
        lat.append(time.perf_counter() - t)
        answers[i] = _plant(ctx, answer)
        del logits, x
        i += 1
    wall = time.perf_counter() - t0
    out = {"setup_s": setup_s, "attempted": len(lat), "failed": 0,
           "window": {"kind": "request", "seconds": wall, "units": len(lat),
                      "latency_s": lat, "host_s": host},
           "work": server.work}
    if ctx.trace:
        from harness.trace import capture
        xs = [server.features(i + j)
              for j in range(ctx.traffic["traced_requests"])]
        out["trace"] = capture(
            lambda j: server.request(xs[j]).argmax(1).cpu(),
            ctx.traffic["traced_requests"])
        del xs
    out["memory_peak_bytes"] = ctx.memory_peak()
    checksum = server.checksum
    server.free()
    del server
    ctx.release()

    t_ref = time.perf_counter()
    inputs = ctx.model.make_inputs(ctx.cfg, ctx.seed, ctx.device)
    if inputs["checksum"] != checksum:
        raise RuntimeError("the inputs made again from the seed differ")
    gap = 0.0
    for j in _sample(ctx, list(answers)):
        x = ctx.model.request_features(ctx.cfg, ctx.seed, j,
                                       inputs["counts"], ctx.device)
        ref = ctx.reference.forward(ctx.cfg, inputs, x)
        gap = max(gap, compare.served_gap(answers[j], ref))
        del ref, x
    out["failed"] = sum(1 for a in answers.values()
                        if a.shape[0] != inputs["counts"]["paper"])
    out["numbers"] = {"served_gap": gap if math.isfinite(gap) else math.inf}
    out["reference_s"] = time.perf_counter() - t_ref
    return out
