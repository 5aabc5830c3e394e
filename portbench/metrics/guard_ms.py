"""The viewer loop's host cap guard a frame: the host clock around the
engine's ``_guard`` in each frame of the traced window. Absent, never 0,
where the program has no such method."""


def read(ctx):
    ms = ctx.get("guard_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
