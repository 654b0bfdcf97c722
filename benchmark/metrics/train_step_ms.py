"""train_step_ms: the window's wall time over the steps it completed, in
ms (host clock; the window closes with one synchronize)."""


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "step" or not w["units"]:
        return None
    return w["seconds"] / w["units"] * 1e3
