"""Reading a ``torch.profiler`` trace of the window.

The device's busy time is the union of its kernel, copy and set
intervals (the arithmetic of the program's ``frame_profile``); the idle
gaps between them are labelled by the benchmark's own span that was
open on the host at the gap's middle (``inputs``, ``render``,
``readback``, ``guard``: the innermost wins).
"""

from __future__ import annotations

SPANS = ("inputs", "render", "readback", "guard")


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy(merged) -> float:
    return sum(e - s for s, e in merged)


def gaps(merged, lo: float, hi: float) -> list:
    """Idle (start, end) stretches of [lo, hi] outside ``merged``."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def label_gaps(idle, spans) -> dict:
    """{label: idle seconds} over ``idle`` gaps (us), each labelled by the
    innermost (latest-opened) span (start, end, name) open at its middle,
    or "other"."""
    marks = [(s, 0, k) for k, (s, _, _) in enumerate(spans)]
    marks += [(e, 2, k) for k, (_, e, _) in enumerate(spans)]
    marks += [((s + e) / 2, 1, k) for k, (s, e) in enumerate(idle)]
    open_: list = []
    out: dict = {}
    for _, kind, k in sorted(marks):
        if kind == 0:
            open_.append(k)
        elif kind == 2:
            open_.remove(k)
        else:
            name = spans[open_[-1]][2] if open_ else "other"
            s, e = idle[k]
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out


def read(prof) -> dict:
    """A finished profile → {"device": [(start_us, end_us, name)],
    "spans": [(start_us, end_us, name)], "window": (start_us, end_us)}.

    Reads the profiler's flat event list (``kineto_results``), which
    costs a tenth of building ``prof.events()``' tree."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, win = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s, e = ev.start_ns() / 1e3, ev.end_ns() / 1e3
        if ev.device_type() == cuda:
            # the host spans' mirrors on the device timeline are no work
            if not ev.is_user_annotation() and name not in SPANS + ("window",):
                dev.append((s, e, name))
        elif name == "window":
            win = (s, e)
        elif name in SPANS:
            spans.append((s, e, name))
    return dict(device=dev, spans=spans, window=win)


def summary(raw: dict, items: int) -> dict:
    """The traced window's numbers: busy and window seconds, kernels by
    name, launches, and the breakdown's two lists."""
    lo, hi = raw["window"]
    dev = [(max(s, lo), min(e, hi), n) for s, e, n in raw["device"]
           if e > lo and s < hi]
    merged = union((s, e) for s, e, _ in dev)
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    idle = label_gaps(gaps(merged, lo, hi), raw["spans"])
    return dict(
        items=items, busy_s=busy(merged) / 1e6, window_s=(hi - lo) / 1e6,
        kernel_s=by_name,
        launches=sum(not n.startswith(("Memcpy", "Memset")) for _, _, n in dev),
        device_ops=sorted(([n[:100], s] for n, s in by_name.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=sorted(([n, s] for n, s in idle.items()),
                         key=lambda x: -x[1])[:10])
