"""The program's own spans, read from its recorder.

The port records every named span it opens while a profiler records
(``mt_renderer_tpu_torch.utils.profiling.span``) in a process-wide table
of calls and host seconds. The harness does not clear that table when
its window starts, so a reading is taken only where the table holds the
window's frames and nothing else: the engine's guard (``engine.guard``)
opens exactly once a frame, and its count has to equal the window's
items. A program without that table (an older checkout), a span that
never opened, or a table that holds another stretch too gives None: the
metric is left out of the line, never 0 and never another run's number.
"""

from __future__ import annotations

PER_FRAME = "engine.guard"


def totals() -> dict:
    """The program's ``{span: (calls, host seconds)}``, or {} where it
    keeps no such table."""
    from mt_renderer_tpu_torch.utils import profiling

    read = getattr(profiling, "span_totals", None)
    return read() if read is not None else {}


def ms_per_frame(ctx: dict, *names: str) -> float | None:
    """The host ms of the spans ``names`` together, over the frames of
    the traced window; None where none of them opened, or where the
    table's ``engine.guard`` count is not the window's frame count."""
    items = ctx["trace"]["items"]
    got = totals()
    if not items or got.get(PER_FRAME, (0, 0.0))[0] != items:
        return None
    seconds = [got[n][1] for n in names if n in got]
    if not seconds:
        return None
    return 1e3 * sum(seconds) / items
