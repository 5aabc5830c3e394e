"""The bc1 pool's sampling a shade: the host milliseconds of each
``shade.bc1`` span of the traced window, the program's own span around
the bc1 sampling inside the frame's shade
(``mt_renderer_tpu_torch.utils.profiling.span_totals``). Under the
benchmark's profiler this is mostly the host issuing the decode's ops.
Absent, never 0, where the program opens no such span."""


def read(ctx):
    from mt_renderer_tpu_torch.utils import profiling

    calls, seconds = profiling.span_totals().get("shade.bc1", (0, 0.0))
    if not calls:
        return None
    return 1e3 * seconds / calls
