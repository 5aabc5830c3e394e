"""Named spans, the profiler trace and logging set-up.

The reference's only instrumentation is an unused per-frame ``Duration``
(renderer_app_manager.rs:162-165) and ``log``-crate tracing gated by
``RUST_LOG`` (SURVEY §5). Here:

* ``span(name)`` — a named range around a part of the frame path (the
  engine's guard and its predictors, the frame's stages, the served
  request). It is on exactly while a ``torch.profiler`` records: then it
  opens a ``record_function`` range, which the trace shows on the
  profiler's clock beside the kernels it launched, and adds one call and
  its host time to a process-wide table (``span_totals``,
  ``reset_spans``). Off, it costs one flag test;
* ``count(name, n)`` — adds ``n`` to a process-wide counter table beside
  the spans' (``count_totals``; ``reset_spans`` clears it too), on the
  same terms: only while a ``torch.profiler`` records, two flag tests
  off. A caller counts from tensor shapes, never from a readback.
  ``recording()`` takes the counts of a block whatever the profiler
  does (a CUDA graph's capture, which its replays count again);
* ``trace(...)`` — a context manager around ``torch.profiler``; the
  Chrome trace it writes opens in Perfetto (or ``chrome://tracing``) and
  shows the spans, the CUDA kernels (K1 under its ``__global__`` name,
  beside the ``mtr::raster_fwd_*`` op that launched it), the torch ops
  and the host↔device copies of each frame;
* ``setup_logging`` — ``MTR_LOG`` env var as the ``RUST_LOG`` analog.
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _profiler


def setup_logging(default: str = "WARNING") -> None:
    """Configure the package logger from ``MTR_LOG`` (e.g. DEBUG, INFO)."""
    level = os.environ.get("MTR_LOG", default).upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.WARNING),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


_OFF = contextlib.nullcontext()
# name -> [calls, host nanoseconds], spans recorded under a profiler
_TOTALS: dict = {}
# name -> sum of ``count``'s n under a profiler
_COUNTS: dict = {}
# the open ``recording()`` tables, innermost last
_RECORDING: list = []


@contextlib.contextmanager
def _recorded(name: str):
    """A ``record_function`` range whose host time goes to the table."""
    with torch.profiler.record_function(name):
        t0 = time.perf_counter_ns()
        yield
        dt = time.perf_counter_ns() - t0
    row = _TOTALS.setdefault(name, [0, 0])
    row[0] += 1
    row[1] += dt


def span(name: str):
    """A context manager around a named part of the work: off (one
    shared null context) unless a ``torch.profiler`` is recording."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while a ``torch.profiler`` records;
    off, nothing. Inside ``recording()`` it adds to the recording
    instead, profiler or not."""
    if _RECORDING:
        _RECORDING[-1][name] = _RECORDING[-1].get(name, 0) + n
    elif _profiler._is_profiler_enabled:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Yield a ``{name: total}`` table that takes every ``count`` made
    inside the block, with or without a profiler, in place of the
    counter table: what a CUDA graph's capture counts, for each of its
    replays to ``count`` again."""
    table: dict = {}
    _RECORDING.append(table)
    try:
        yield table
    finally:
        _RECORDING.pop()


def span_totals() -> dict:
    """``{name: (calls, host seconds)}`` of the spans closed since the
    last ``reset_spans``."""
    return {k: (n, ns / 1e9) for k, (n, ns) in _TOTALS.items()}


def count_totals() -> dict:
    """``{name: total}`` of the counters since the last ``reset_spans``."""
    return dict(_COUNTS)


def reset_spans() -> None:
    """Clear the span and the counter tables."""
    _TOTALS.clear()
    _COUNTS.clear()


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace of the block: CPU activity, plus CUDA
    activity when a card is visible. On exit it writes a Chrome trace to
    ``log_dir``/``TRACE_FILE`` (default ``log_dir``: ``mtr_trace`` in the
    temporary directory). Resets the span and counter tables on entry.
    Yields ``log_dir``."""
    log_dir = str(Path(tempfile.gettempdir()) / "mtr_trace"
                  if log_dir is None else log_dir)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))
