"""The share of the bc7 pool's sampling that the hand kernel ran: eight
times the program's counter ``bc7.kernel_taps`` (the taps handed to
``csrc/bc7_trilinear.cu`` through the op ``mtr::bc7_trilinear``) over its
``bc7.texels`` (the texels the ``shade.bc7`` spans decode, eight a tap),
in the traced window (``mt_renderer_tpu_torch.utils.profiling``). 1.0
when every shade runs the kernel. Absent, never 0, where either counter
is missing: a program without the kernel counts no taps."""


def read(ctx):
    from mt_renderer_tpu_torch.utils import profiling

    totals = getattr(profiling, "count_totals", None)
    counts = totals() if totals is not None else {}
    taps, texels = counts.get("bc7.kernel_taps"), counts.get("bc7.texels")
    if taps is None or not texels:
        return None
    return 8 * taps / texels
