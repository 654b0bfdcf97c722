"""Full-batch training steps, back to back.

Set-up builds the trainer (the model file's `build`), then drives it
through the traffic's ``checked_steps`` first steps by the window's own
call, each on its own step mask; those steps warm every shape up. The
window then calls the same step on the same object for ``--seconds``,
each step's loss left on the device, and closes with one synchronize:
the step time is the window's wall time over the steps it completed.

After the window (and the trace, with ``--trace 1``), the peak memory is
read, the trainer freed, and the reference follows the checked steps
from the same inputs, made again from the seed.
"""

import math
import time

import torch

from harness import compare, env


def _readings(ctx, system):
    """The checked steps through the window's call: losses, the first
    gradient from the optimizer's state, and the change of the weights."""
    losses, grads = [], None
    for i in range(ctx.traffic["checked_steps"]):
        losses.append(system.step(i))
        if i == 0:
            grads = system.first_grads()
    after = system.snapshot()
    return {"losses": [float(v) for v in losses], "grads": grads,
            "delta": {k: after[k] - system.init[k] for k in after}}


def _plant(ctx, system):
    """Faults that a test or a calibration run plants under the timed path:
    ``unchanged``: the step leaves the weights and optimizer as they were;
    ``half_batch``: the step sees half of its mask's rows, the mean taken
    over the rest."""
    if ctx.plant == "unchanged":
        saved = system.snapshot()
        inner = system.step

        def step(i):
            loss = inner(i)
            with torch.no_grad():
                for k, t in system.params.items():
                    t.copy_(saved[k])
                for st in system.opt.state.values():
                    for v in st.values():
                        if torch.is_tensor(v) and v.dim():
                            v.zero_()
            return loss
        system.step = step
    elif ctx.plant == "half_batch":
        halves = []
        for m in system.ms:
            keep = torch.zeros_like(m)
            idx = torch.nonzero(m).flatten()
            keep[idx[: idx.numel() // 2]] = 1
            halves.append(m * keep)
        system.ms = halves
    elif ctx.plant:
        raise ValueError(f"unknown fault {ctx.plant}")


def run(ctx):
    steps = ctx.traffic["checked_steps"]
    make_inputs = getattr(ctx.model, "make_train_inputs",
                          ctx.model.make_inputs)
    if ctx.control:
        ctx.phases.mark("graph")
        prog = ctx.reference.train(
            ctx.cfg, make_inputs(ctx.cfg, ctx.seed, ctx.device), steps,
            rnd=compare.fp8)
        ref = ctx.reference.train(
            ctx.cfg, make_inputs(ctx.cfg, ctx.seed, ctx.device), steps)
        numbers, worst = compare.training_numbers(prog, ref)
        return {"numbers": numbers, "worst": worst,
                "setup_s": ctx.phases.since_start(), "attempted": steps,
                "failed": 0}

    system = ctx.model.build_trainer(ctx.cfg, ctx.seed, ctx.device, ctx.phases)
    _plant(ctx, system)
    prog = _readings(ctx, system)
    env.sync(ctx.device)
    ctx.phases.mark(f"warm-up ({steps} checked steps)")
    setup_s = ctx.phases.since_start()

    host, losses = [], []
    env.sync(ctx.device)
    t0 = time.perf_counter()
    i = steps
    while True:
        t = time.perf_counter()
        losses.append(system.step(i))
        host.append(time.perf_counter() - t)
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    env.sync(ctx.device)
    wall = time.perf_counter() - t0
    failed = sum(1 for v in torch.stack(losses).float().tolist()
                 if not math.isfinite(v))
    out = {"setup_s": setup_s, "attempted": len(losses), "failed": failed,
           "window": {"kind": "step", "seconds": wall, "units": len(losses),
                      "host_s": host},
           "work": system.work}
    if ctx.trace:
        from harness.trace import capture
        n0 = i
        out["trace"] = capture(lambda j: system.step(n0 + j),
                               ctx.traffic["traced_steps"])
    out["memory_peak_bytes"] = ctx.memory_peak()
    checksum = system.checksum
    system.free()
    del system
    ctx.release()

    t_ref = time.perf_counter()
    inputs = make_inputs(ctx.cfg, ctx.seed, ctx.device)
    if inputs["checksum"] != checksum:
        raise RuntimeError("the inputs made again from the seed differ")
    ref = ctx.reference.train(ctx.cfg, inputs, steps)
    out["numbers"], out["worst"] = compare.training_numbers(prog, ref)
    out["reference_s"] = time.perf_counter() - t_ref
    return out
