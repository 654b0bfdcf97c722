"""idle_share.train: the share of the traced window of training steps in
which no operation ran on the device, in %."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "step" or tr is None or tr.window_s <= 0:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100
