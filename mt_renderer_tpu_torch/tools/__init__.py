"""Measurement tools that run on the card: the raster roofline
(``raster_roofline``, with the probe kernel K3) and the bilinear A/B
(``bilin_ab``, with the SWAR kernel K4). Each refuses to run without a
CUDA device: a number taken on the CPU is no reading of the card."""

from __future__ import annotations

import subprocess

import torch


def require_cuda(device=None) -> torch.device:
    """The CUDA device to measure on; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: this tool times the "
                           "card and has no CPU mode")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise RuntimeError(f"this tool times the card, not {dev}")
    return dev


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_times(fn, device, repeats: int, calls: int = 1) -> list[float]:
    """``repeats`` readings of ``fn``'s device time in ms per call, each
    CUDA events around ``calls`` calls (``fn(i)`` for i < calls), after
    one warm-up round."""
    for i in range(calls):
        fn(i)
    torch.cuda.synchronize(device)
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def graph_times(fn, device, repeats: int, calls: int = 1) -> list[float]:
    """``repeats`` readings of ``fn``'s device time alone in ms per call:
    ``fn(i)`` for i < calls captured once into a CUDA graph (after one
    warm-up round), each reading CUDA events around one replay. Unlike
    ``cuda_times``, the host's time between launches (a wrapper's
    checks, allocations and binding) cannot show in it; ``fn`` must not
    synchronise."""
    for i in range(calls):
        fn(i)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize(device)
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    del graph
    return out


def median(xs):
    """The upper median (the reference tools' ``sorted(x)[len // 2]``)."""
    return sorted(xs)[len(xs) // 2]
