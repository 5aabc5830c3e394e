"""The viewer loop's host cap guard, one part a frame: the tile-overlap
test of ``predict_bin_counts`` and the row test of ``predict_live_rows``
(``predict.bins`` + ``predict.rows``), each after its bounding boxes,
the program's spans over the frames of the traced window."""

from portbench.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "predict.bins", "predict.rows")
