"""request_p95_ms: the 95th percentile of every request's latency in the
window, submission to the answer on the host, in ms."""

import statistics


def read(ctx):
    w = ctx["window"]
    lat = w.get("latency_s") or []
    if w["kind"] != "request" or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
