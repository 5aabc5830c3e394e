"""The viewer loop's host cap guard, one part a frame: the rest of the
guard's two bounding-box passes: clip, NDC, area and padded chunk
bounding boxes (``predict.project``), the program's span over the frames
of the traced window."""

from portbench.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "predict.project")
