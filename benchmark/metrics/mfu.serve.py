"""mfu.serve: a request's share of the card's peak: the least time its
operations take at the published peak of each operation's dtype
(harness/work.py), over the traced time of a request, in %."""

from harness.work import least_seconds_by_flops


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "request" or tr is None or not tr.units:
        return None
    return least_seconds_by_flops(ctx["work"]) * tr.units / tr.window_s * 100
