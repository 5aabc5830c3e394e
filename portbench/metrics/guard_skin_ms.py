"""The viewer loop's host cap guard, one part a frame: the host skinning of
the guard's two bounding-box passes (``predict.skin``,
``cpu_reference.skin_positions``), the program's span over the frames of
the traced window."""

from portbench.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "predict.skin")
