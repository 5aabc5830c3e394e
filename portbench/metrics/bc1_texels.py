"""The texels the bc1 pool's sampling decodes a shade: the program's
counter ``bc1.texels`` (the shaded rows' pixels times the trilinear
tap's eight texels, from tensor shapes) over its ``shade.bc1`` spans in
the traced window (``mt_renderer_tpu_torch.utils.profiling``). One
shade a frame in the orbit cells. Absent, never 0, where the program
has no such span or counter."""


def read(ctx):
    from mt_renderer_tpu_torch.utils import profiling

    calls = profiling.span_totals().get("shade.bc1", (0, 0.0))[0]
    totals = getattr(profiling, "count_totals", None)
    texels = totals().get("bc1.texels") if totals is not None else None
    if not calls or texels is None:
        return None
    return texels / calls
