"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and set intervals over the window's length."""


def read(ctx):
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
