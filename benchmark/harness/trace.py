"""A `torch.profiler` capture of a short window and its reduction to device
events: busy seconds (the union of every device operation's interval),
device time by kernel, and the idle gaps named by what the host was doing.

This is the benchmark's own copy of the capture: it reads the profiler's
events itself and takes nothing from the program's timing kit.
"""

import re
import time

import numpy as np

WINDOW_LABEL = "bench.window"
# gaps of the device shorter than this are launch spacing, not idling
# worth naming
_GAP_FLOOR_NS = 5_000
_GAPS_NAMED = 500


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _is_annotation(ev):
    f = getattr(ev, "is_user_annotation", None)
    if f is not None and f():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def short_name(name):
    """A kernel's name without its return type, template arguments and
    parameters: ``void spmm_csr_kernel<bf16, 4>(...)`` -> spmm_csr_kernel."""
    s = re.sub(r"^void\s+", "", name.strip())
    s = s.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    s = "".join(out).strip()
    return s.split("::")[-1] or name[:80]


class Trace:
    """Device and host events of one traced window, times in ns on the
    profiler's clock."""

    def __init__(self, device_events, host_events, window, units):
        self.device = device_events    # [(name, start, end)]
        self.host = host_events        # [(name, start, end)]
        self.w0, self.w1 = window
        self.units = units

    @property
    def window_s(self):
        return (self.w1 - self.w0) / 1e9

    def intervals(self, pattern=None):
        """(start, end) of the device events in the window whose short
        name matches ``pattern`` (every event when None)."""
        rx = re.compile(pattern) if pattern else None
        return [(max(s, self.w0), min(e, self.w1))
                for name, s, e in self.device
                if e > self.w0 and s < self.w1
                and (rx is None or rx.search(short_name(name)))]

    def seconds(self, pattern=None):
        """Summed device time of the matching events (None when nothing
        matches)."""
        iv = self.intervals(pattern)
        if not iv:
            return None
        return sum(e - s for s, e in iv) / 1e9

    def busy_intervals(self):
        iv = sorted(self.intervals())
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ops(self, top=10):
        by = {}
        for name, s, e in self.device:
            if e > self.w0 and s < self.w1:
                k = short_name(name)
                by[k] = by.get(k, 0) + (min(e, self.w1) - max(s, self.w0))
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in rows]

    def idle_gaps(self, top=10):
        """The device's idle time in the window, by the innermost host
        event running at the middle of each gap."""
        merged = self.busy_intervals()
        edges = [self.w0] + [x for iv in merged for x in iv] + [self.w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] - edges[i] >= _GAP_FLOOR_NS]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:_GAPS_NAMED]
        hosts = [h for h in self.host if h[0] != WINDOW_LABEL]
        if not gaps:
            return []
        hs = np.array([h[1] for h in hosts] or [0], np.int64)
        he = np.array([h[2] for h in hosts] or [0], np.int64)
        by = {}
        for s, e in gaps:
            mid = (s + e) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            if cover.size and hosts:
                name = hosts[int(cover[np.argmin(he[cover] - hs[cover])])][0]
            else:
                name = "(no host event)"
            by[name] = by.get(name, 0) + (e - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in rows]

    def breakdown(self):
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


def capture(call, units):
    """Run ``call(i)`` for i < units under the profiler, the window closed
    by a synchronize, and return its `Trace`. Without a card (the tests)
    only the host is traced and the device has no events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_LABEL):
            for i in range(units):
                call(i)
            if cuda:
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the device timeline repeats the host's annotations, which
            # are spans of the host's code and not operations
            if not _is_annotation(ev):
                dev.append((name, start, end))
        else:
            host.append((name, start, end))
            if name == WINDOW_LABEL:
                window = (start, end)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    trace = Trace(dev, host, window, units)
    trace.reduce_s = time.perf_counter() - t0
    return trace
