"""requests_per_s: requests completed over the window's seconds."""


def read(ctx):
    w = ctx["window"]
    if w["kind"] != "request" or not w["units"]:
        return None
    return w["units"] / w["seconds"]
