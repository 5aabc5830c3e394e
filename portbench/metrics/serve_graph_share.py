"""The share of the traced window's served requests that replayed the
artifact's CUDA graph: the program's counter ``serve.replays`` over its
``serve.request`` spans, both in the traced window
(``mt_renderer_tpu_torch.utils.profiling``). 1.0 when every request
replays. Absent, never 0, where the counter or the spans are missing: a
program without the graph counts no replays."""


def read(ctx):
    from mt_renderer_tpu_torch.utils import profiling

    totals = getattr(profiling, "count_totals", None)
    replays = (totals() if totals is not None else {}).get("serve.replays")
    requests = profiling.span_totals().get("serve.request", (0, 0.0))[0]
    if replays is None or not requests:
        return None
    return replays / requests
