"""The viewer loop's host cap guard, one part a frame: the world's device
palette read back for the guard's two predictors (``predict.palette``;
absent where the palette is on the host), the program's span over the
frames of the traced window."""

from portbench.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "predict.palette")
