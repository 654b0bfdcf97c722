"""host_ms.serve: the host's time inside one `predict` call, from the call
to its return without a synchronize, the mean over the window, in ms."""


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "request" or not w.get("host_s"):
        return None
    return sum(w["host_s"]) / len(w["host_s"]) * 1e3
