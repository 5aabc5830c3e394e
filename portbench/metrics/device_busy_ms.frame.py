"""The device's busy time a frame: the union of its kernel, copy and set
intervals in the traced window over the frames completed in it."""


def read(ctx):
    tr = ctx["trace"]
    if tr["busy_s"] <= 0 or not tr["items"]:
        return None
    return 1e3 * tr["busy_s"] / tr["items"]
