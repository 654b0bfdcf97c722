"""host_ms.train: the host's time inside one training step call, from the
call to its return without a synchronize, the mean over the window, in ms
(the benchmark's own span around the call into the port)."""


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "step" or not w.get("host_s"):
        return None
    return sum(w["host_s"]) / len(w["host_s"]) * 1e3
