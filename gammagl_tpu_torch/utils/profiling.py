"""Timing and tracing on the card (counterpart of
`gammagl_tpu/utils/profiling.py`; the reference times with ad-hoc
``time.time()`` deltas, profiler/ggl/gcn_trainer.py:59).

* `chain_time`: the per-step time of ``step`` over K chained,
  data-dependent applications, one scalar fetched at the end, the best of
  ``reps`` repetitions on distinct inputs. A CUDA tensor is timed with
  CUDA events around the chain; a CPU tensor with the host clock.
* `trace`: a `torch.profiler` capture (CPU activity always, CUDA
  activity when a card is present) that waits for the card before it
  closes and writes a Chrome trace under ``logdir`` (Perfetto or
  ``chrome://tracing`` read it).
* `device_timer`: a host-clock bracket that waits for the card on exit
  and sends one ``"<label>: <seconds>s"`` line to ``sink``.

These are the port's own timing tools: kernel-grade numbers come from
`chain_time` or a trace's device events, never from the host clock alone.
"""

import contextlib
import os
import time

import torch

__all__ = ["chain_time", "trace", "device_timer"]


def chain_time(step, x0, K=8, reps=3, perturb=None):
    """Seconds per application of ``step`` (tensor -> tensor of the same
    shape), measured as K chained applications, each bounded by
    ``h / (max|h| + 1)`` so the next depends on it.

    One warm-up chain, then ``reps`` chains, repetition r on
    ``perturb(x0, r)`` (default ``x0 + r`` in x0's dtype), each ending in
    one scalar fetched to the host; returns min(chain) / K. ``step`` is
    called K * (reps + 1) times, without autograd. On a CUDA tensor each
    chain is timed by CUDA events recorded around it on the current
    stream; on the CPU by ``time.perf_counter``.
    """
    if perturb is None:
        def perturb(x, r):
            return x + torch.tensor(r, dtype=x.dtype, device=x.device)

    cuda = x0.device.type == "cuda"

    def run(x):
        h = x
        for _ in range(K):
            h = step(h)
            h = h / (h.abs().max() + 1.0)  # bound + data dependency
        return h.float().sum()

    with torch.no_grad():
        float(run(x0))  # warm: builds, caches, allocator
        ts = []
        for r in range(reps):
            xr = perturb(x0, r)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(x0.device)
                start.record()
                total = run(xr)
                stop.record()
                float(total)
                ts.append(start.elapsed_time(stop) / 1e3)
            else:
                t0 = time.perf_counter()
                float(run(xr))
                ts.append(time.perf_counter() - t0)
    return min(ts) / K


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir):
    """Capture a timeline: ``with trace("traces") as prof: step()``.

    A `torch.profiler.profile` with CPU activity, and CUDA activity when a
    card is present; the card is synchronized before the capture closes,
    so no queued work leaks past it. On exit the Chrome trace is written
    to ``<logdir>/trace_<pid>_<n>.json`` and its path set as
    ``prof.trace_path``; ``prof.key_averages()`` works as usual.
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    path = os.path.join(str(logdir),
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


@contextlib.contextmanager
def device_timer(label="block", sink=print):
    """Coarse host-clock bracket that waits for the card on exit (for
    kernel-grade numbers prefer `chain_time`); sends
    ``f"{label}: {seconds:.4f}s"`` to ``sink``."""
    t0 = time.perf_counter()
    yield
    _sync()
    sink(f"{label}: {time.perf_counter() - t0:.4f}s")
