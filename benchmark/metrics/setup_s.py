"""setup_s: from the process's start to the window's first call: imports,
the kernel library, graph, plans, transfer and the warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
