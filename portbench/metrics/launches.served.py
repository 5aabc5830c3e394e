"""Kernel launches a request: the profiler's device kernels (copies and
sets left out) in the traced window over the requests completed in it."""


def read(ctx):
    tr = ctx["trace"]
    if not tr["launches"] or not tr["items"]:
        return None
    return tr["launches"] / tr["items"]
