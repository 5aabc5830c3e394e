#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mt_renderer_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's main paths once at the headline sizes: the skinned,
textured demo scene (1024 instances at subdiv 4, 196,608 triangles) at
1920x1080 with the quad texel pool, single-layer through
``FrameEngine`` and ``render_frame(packed=True)``; its glass variant
(every 4th instance translucent, the camera inside the cube field)
through ``FrameEngine(peel=4, peel_mode="split")`` and
``render_frame_peeled``; the same scene with the tri texel pool,
mipmapped and lit, through ``FrameEngine(mipmap=True, lighting=True)``
(the reference bench's ``pallas+mip+light`` row); the glass scene with
the tri pool through ``FrameEngine(peel=4, mipmap=True,
lighting=True)`` (the ``peel4+mip+light`` row); the archive world (280
buildings, 239,664 triangles, the tri pool, mipmapped, the characters
posed on the card: the ``pallas world`` row); and the two probe tools'
paths, shortened: ``tools.raster_roofline`` on its ``default`` and
``world`` presets and ``tools.bilin_ab``. Phases, each of which raises
on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build K1 (``csrc/raster_fwd.cu``), K2 (``csrc/raster_fwd_ml.cu``),
   K3 (``csrc/raster_micro.cu``) and K4 (``csrc/bilin_swar.cu``), every
   ``nvcc`` process at once, and print ptxas' register, shared memory
   and spill report;
3. K1 against its plain PyTorch version on the card at the headline
   shapes: winner ids, tap addresses and coverage equal, z and the tap
   planes within 2 ulp (bit-equal is expected: both are built without
   FMA contraction); both timed (the kernels of K1 and K2, here and
   below, by CUDA-graph replay, their device time alone; the plain
   versions, which synchronise, by CUDA events); and K1's breakdown
   line (its time with every chunk count zeroed and with no winner, so
   no coefficient gathers, CTAs per SM, the per-tile pair tail against a
   CTA's share, the surviving (triangle, warp) pairs of its cull's plain
   twin, and a check that every winner survived its warp's cull),
   printed again at phases 9 and 13;
4. the fixture golden (96x96, ``tests/golden/fixture_scene_96.npz``)
   under the golden rule (at most 0.3% of pixels with a channel off by
   more than 1);
5. the single-layer main path: 20 frames through ``FrameEngine`` with
   the camera yaw and the bone palette varying per frame; at least one
   K1 launch per frame, no overflow, frame 0 equal under the golden rule
   to the same frame through the plain raster;
6. K2 against its plain version at the glass headline (the translucent
   set's binning, no opaque cull, K1's opaque z-buffer as ``zhi``,
   L = 4) and, with the opaque cull, on the opaque headline scene: in
   every layer ids and coverage equal, tap addresses equal, z and the
   tap planes within 2 ulp; both timed with CUDA events, each with K2's
   breakdown line (its time with every chunk count zeroed beside a
   plain ``zero_`` of its output bytes, CTAs per SM, the per-tile pair
   tail against a CTA's share, the surviving (triangle, warp) pairs of
   its cull's plain twin, and a check that every id kept in any layer
   survived its warp's cull), printed again at phase 10;
7. the split peel equals the ml peel bit for bit, color and depth, on
   opaque scenes: at the reference's verify-leg size (256x256, 9
   instances, subdiv 2, L = 3, caps from ``measure_live_tap_tiles``)
   and at the opaque headline with L = 4;
8. the glass main path: 20 frames through ``FrameEngine(peel=4,
   peel_mode="split")`` with yaw and bones varying as in phase 5; at
   least one K1 and one K2 launch in every frame, no overflow, frame 0
   equal under the golden rule to the same frame through both plain
   rasters;
9. K1's mtap + lit epilogues against their plain version at the
   mip+light headline (tri pool), and 20 frames of
   ``FrameEngine(mipmap=True, lighting=True)`` as in phase 5;
10. K2's mtap + lit epilogues against their plain version at the glass
    headline with the tri pool (the split peel's translucent set, no
    opaque cull, ``zhi``) and at the opaque mip+light headline through
    the ml peel (full, the opaque cull), L = 4: ids, coverage and every
    plane equal (0 ulp expected); both timed;
11. the split peel equals the ml peel bit for bit on the opaque
    mip+light headline (the ml peel's frame is K2 ``full``'s path, its
    launches counted from 0), and 20 frames of ``FrameEngine(peel=4,
    peel_mode="split", mipmap=True, lighting=True)`` on the glass scene
    with the tri pool: K1 and K2 in every frame, no overflow, frame 0
    under the golden rule against both plain rasters;
12. the world's verify legs (``verify.world_legs``: 256x144, 130
    buildings): the invariants, the packed and the characters' frames
    against the NumPy oracle, the mipmapped frame against the plain
    raster, the palette animating;
13. the world main path: 20 frames of the full world at 1920x1080 with
    the caps sized at frame 0 (as the reference bench sizes them), each
    frame's palette computed on the card by ``bone_mats_device``; frame
    0's palette and frame equal, bit for bit, to the host palette's; K1
    (mtap) against its plain version on frame 0's inputs;
14. K3 against its plain version on a chunk that covers nothing of its
    tile and on two that cover it, then timed over the full grid; the
    roofline on ``default`` (2 views), whose rates line gives K3's two
    rates (ns per (group, warp) cull test, ns per surviving (triangle,
    warp)), and on ``world`` (8 views) at those rates; K4 against its
    plain version and the bilinear A/B.

Each main path runs with every launch count set to 0 just before it and
read just after. Prints the card's name and power limit, then every
kernel's record (its launches on its main path, its error against the
plain version, its time, the plain version's time and the bound: the
larger of its bytes over HBM bandwidth and its f32 operations over the
f32 peak, both from NVIDIA's H100 SXM data sheet, K1's and K2's
operations their cull tests and their surviving pairs' pixels; their
records also the surviving pairs, the earlier every-binned-pair bound,
the zero-count time and the floor at K3's rates, K1's its no-winner
time, K2's the fill of its output bytes; K2 has three records: tap on
the glass loop, mtap + lit on the peeled mip+light loop, ``full`` on
the opaque mip+light headline's ml peel) as one JSON line before the
last, and as its last line ``{"ok": true, "device": {...}}``.
Exits non-zero, with no result, when no CUDA device is visible.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "fixture_scene_96.npz"
KERNEL_SOURCE = "mt_renderer_tpu_torch/csrc/raster_fwd.cu"
KERNEL_REPLACES = "mt_renderer_tpu/render/pallas_raster.py:618"
ML_KERNEL_SOURCE = "mt_renderer_tpu_torch/csrc/raster_fwd_ml.cu"
ML_KERNEL_REPLACES = "mt_renderer_tpu/render/pallas_raster.py:843"
MICRO_SOURCE = "mt_renderer_tpu_torch/csrc/raster_micro.cu"
MICRO_REPLACES = "tools/bench/raster_roofline.py:177"
SWAR_SOURCE = "mt_renderer_tpu_torch/csrc/bilin_swar.cu"
SWAR_REPLACES = "tools/bench/bilin_ab.py:87"
HEADLINE = dict(instances=1024, subdiv=4, width=1920, height=1080)
GLASS = dict(HEADLINE, translucent=True, cam_scale=0.3)
MIP = dict(HEADLINE, pool_mode="tri")
GLASS_MIP = dict(GLASS, pool_mode="tri")
WORLD = dict(buildings=280, building_subdivs=(4, 6, 8, 10, 12),
             width=1920, height=1080)       # the bench's world row
MICRO_REPS = 16             # reps of the timed probe against its twin
VERIFY_LEG = dict(instances=9, subdiv=2, width=256, height=256)
LAYERS = 4                  # the glass preset's peel depth
FRAMES = 20
GOLDEN_SHARE = 0.003        # pixels allowed a channel off by more than 1
ULP_TOL = 2
# NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
PLANE_OPS = 16              # 3 edge functions + the z plane, 2 mul + 2 add
CULL_OPS = 12               # a (triangle, warp) cull test: 3 corner edge
                            # functions, 2 mul + 2 add each


def log(msg: str) -> None:
    print(msg, flush=True)


def golden_share(got_u8: np.ndarray, want_u8: np.ndarray) -> tuple:
    """(share of pixels with a channel off by more than 1, count of
    pixels that differ at all)."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    dmax = diff.max(-1)
    return float((dmax > 1).mean()), int((dmax > 0).sum())


def ulp_dist(a, b):
    """Per-element distance in units in the last place between two f32
    tensors (0 for +0 vs -0)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)

    return (ordered(a) - ordered(b)).abs()


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``reps``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 10) -> float:
    """Median device time of ``fn`` alone in ms: ``calls`` calls
    replayed from a CUDA graph (``tools.graph_times``), so a wrapper's
    host time between launches cannot show in it."""
    import torch

    from mt_renderer_tpu_torch.tools import graph_times, median

    return median(graph_times(lambda _i: fn(), torch.device("cuda"), 5,
                              calls=calls))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(n_bytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the f32 operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def binned_pairs(lists, glists) -> int:
    """Live (tile, 32-triangle group) pairs: the popcount of the tiles'
    group masks, the raster kernels' unit of work."""
    import torch

    from mt_renderer_tpu_torch.render import raster as rs

    g = torch.where(lists >= 0, glists, 0)
    return sum(int(((g >> k) & 1).sum()) for k in range(rs.G))


def raster_bound(args, outs, zhi, surviving: int) -> dict:
    """A raster kernel's bound on these inputs: each input read once,
    each output written once, and the f32 operations its work needs. K1
    and K2 run one cull test (CULL_OPS) per binned (triangle, warp) pair
    and evaluate three edge functions and the z plane (PLANE_OPS) only
    at the pixels of the pairs that survive the cull (``surviving``, from
    its plain twin on these inputs; K2's list insertions are left out,
    so its bound is the lower). Their
    ``binned_bound_ms`` keeps the every-binned-(triangle, pixel)-pair
    figure of the earlier designs' records."""
    from mt_renderer_tpu_torch.render import raster as rs

    cols, lists, glists, counts = args[:4]
    pairs = binned_pairs(lists, glists)
    n_bytes = nbytes(cols, lists, glists, counts, zhi, *outs)
    binned = bound(n_bytes, pairs * rs.KG * rs.P * PLANE_OPS)
    return dict(pairs=pairs, binned_bound_ms=binned["bound_ms"], **bound(
        n_bytes, pairs * rs.WARPS * rs.KG * CULL_OPS
        + surviving * rs.WARP_W * rs.WARP_H * PLANE_OPS))


def outside_live(live, lists, ids) -> int:
    """Kept ids (``ids`` (n_tiles, P) i32, -1 where none) whose (triangle,
    warp) pair the cull twin's ``live`` (n_tiles, maxc, G, WARPS, KG)
    rejects at the pixel's warp: 0 when the kernel's cull is safe for
    this output."""
    import torch

    from mt_renderer_tpu_torch.render import raster as rs

    dev = ids.device
    wp = torch.arange(rs.P, device=dev)
    row, col = wp // rs.TILE_W, wp % rs.TILE_W
    warp = ((col // rs.PART_W) * (rs.WARPS // rs.PARTS)
            + (row // rs.WARP_H) * (rs.PART_W // rs.WARP_W)
            + (col % rs.PART_W) // rs.WARP_W)
    win = ids.clamp(min=0).long()
    slot = (lists[:, :, None] == (win // rs.CT)[:, None, :]).int().argmax(1)
    ok = live[torch.arange(ids.shape[0], device=dev)[:, None], slot,
              (win % rs.CT) // rs.KG, warp[None, :], win % rs.KG]
    return int(((ids >= 0) & ~ok).sum())


def k1_breakdown(args, kw, got, what: str) -> dict:
    """K1's breakdown and bound on these inputs, logged as one line: its
    device time (``graph_ms``) with every chunk count set to 0 (launch,
    epilogue without gathers, output writes) and with no winner (every z plane at -1:
    the same cull and evaluation, no coefficient gathers; the difference
    to K1's time prices the gathers), its CTAs per SM, the per-tile live
    pairs' maximum against a CTA's share, and the surviving (triangle,
    warp) pairs of its cull (``raster.warp_cull_reference``, checked
    against the kernel: every pixel the kernel covers lies in a warp that
    kept its winner), as ``tools.raster_roofline`` reads them. → the
    surviving count, both times and ``raster_bound``."""
    import torch

    from mt_renderer_tpu_torch.render import raster as rs
    from mt_renderer_tpu_torch.tools import raster_roofline as rr

    cols, lists, glists, counts, origin = args
    dev = cols.device
    empty = torch.zeros_like(counts)
    empty_ms = graph_ms(lambda: rs.raster_fwd(cols, lists, glists, empty,
                                              origin, **kw))
    nowin = rr.no_winner(cols)
    nowin_ms = graph_ms(lambda: rs.raster_fwd(nowin, lists, glists, counts,
                                              origin, **kw))
    del nowin
    bps = rs.blocks_per_sm(dev)
    resident = torch.cuda.get_device_properties(dev).multi_processor_count \
        * bps
    hist = rr.pair_histogram(rr.tile_pairs(lists, glists, counts), resident,
                             rs.PARTS)
    live = rs.warp_cull_reference(cols, lists, glists, counts, origin,
                                  width=kw["width"], height=kw["height"])
    surviving = int(live.sum())
    # every covered pixel's winner survived its warp's cull
    n_bad = outside_live(live, lists, got[1][:, 0, :])
    log(f"K1 breakdown, {what}: counts=0 {empty_ms!r} ms; no winner "
        f"{nowin_ms!r} ms; {bps} CTAs per "
        f"SM ({resident} resident, {rs.PARTS} per tile); pairs "
        f"{hist['pairs']} over {hist['live_tiles']} tiles, max "
        f"{hist['max']}, p90 {hist['p90']!r}, mean {hist['mean']!r}, a "
        f"CTA's share {hist['share']!r}, heaviest/share "
        f"{hist['heavy_over_share']!r}; surviving (triangle, warp) "
        f"{surviving} of {hist['pairs'] * rs.WARPS * rs.KG} binned; "
        f"winners outside their warp's live mask: {n_bad}")
    if n_bad:
        raise AssertionError(f"{what}: a winner the cull twin rejects")
    return dict(surviving=surviving, empty_ms=empty_ms, nowin_ms=nowin_ms,
                **raster_bound(args[:4], got, None, surviving))


def k2_breakdown(args, kw, got, what: str) -> dict:
    """K2's breakdown and bound on these inputs (``kw`` its keywords),
    logged as one line: its device time (``graph_ms``) with every chunk
    count set to 0 (the launch and the L layers' writes) beside a plain
    ``zero_`` of the same output bytes, its CTAs per SM, the per-tile live pairs' maximum
    against a CTA's share, and the surviving (triangle, warp) pairs of
    its cull (``raster.warp_cull_reference``), checked against the
    kernel: every id kept in any layer lies in a (triangle, warp) pair
    that survives it. → the surviving count, both times and
    ``raster_bound``."""
    import torch

    from mt_renderer_tpu_torch.render import raster as rs
    from mt_renderer_tpu_torch.tools import raster_roofline as rr

    cols, lists, glists, counts, origin = args
    dev = cols.device
    zhi = kw.get("zhi")
    empty = torch.zeros_like(counts)
    empty_ms = graph_ms(lambda: rs.raster_fwd_ml(cols, lists, glists, empty,
                                                 origin, **kw))
    buf = torch.empty(nbytes(*got) // 4, dtype=torch.float32, device=dev)
    fill_ms = graph_ms(buf.zero_)
    del buf
    bps = rs.ml_blocks_per_sm(dev, kw["layers"], kw["opaque_cull"],
                              zhi is not None)
    resident = torch.cuda.get_device_properties(dev).multi_processor_count \
        * bps
    hist = rr.pair_histogram(rr.tile_pairs(lists, glists, counts), resident,
                             rs.PARTS)
    live = rs.warp_cull_reference(*args, width=kw["width"],
                                  height=kw["height"])
    surviving = int(live.sum())
    il = got[1]
    n_bad = sum(outside_live(live, lists, il[:, i])
                for i in range(il.shape[1]))
    log(f"K2 breakdown, {what}: counts=0 {empty_ms!r} ms, zero_ of its "
        f"{nbytes(*got) / 1e6!r} MB {fill_ms!r} ms; {bps} CTAs per SM "
        f"({resident} resident, {rs.PARTS} per tile); pairs "
        f"{hist['pairs']} over {hist['live_tiles']} tiles, max "
        f"{hist['max']}, p90 {hist['p90']!r}, mean {hist['mean']!r}, a "
        f"CTA's share {hist['share']!r}, heaviest/share "
        f"{hist['heavy_over_share']!r}; surviving (triangle, warp) "
        f"{surviving} of {hist['pairs'] * rs.WARPS * rs.KG} binned; kept "
        f"ids outside their warp's live mask: {n_bad}")
    if n_bad:
        raise AssertionError(f"{what}: a kept id the cull twin rejects")
    return dict(surviving=surviving, empty_ms=empty_ms, fill_ms=fill_ms,
                **raster_bound(args[:4], got, zhi, surviving))


def phase_device() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    log(f"device: {name} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    for line in smi.strip().splitlines():
        log(line.strip())
    return dict(kind=name, count=count)


def phase_build() -> None:
    from mt_renderer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {', '.join(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.KERNELS:
        log(f"ptxas report of {name}:")
        for line in _build.ptxas_report(name).splitlines():
            log(f"  {line.strip()}")


def reset_launches() -> None:
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    rs.raster_fwd.launches = 0
    rs.raster_fwd_ml.launches = 0
    rs.raster_micro.launches = 0
    dv.bilin_swar.launches = 0


def headline_case(device, *, instances: int, subdiv: int, width: int,
                  height: int, translucent: bool = False,
                  cam_scale: float = 1.0, phase: float = 0.0,
                  pool_mode: str = "quad") -> dict:
    """The headline scene (or its glass variant) uploaded to ``device``
    with the ``pool_mode`` texel pool, its camera, the bone palette at
    animation ``phase``, and the caps sized for that view the way
    ``bench.py`` sizes them."""
    from mt_renderer_tpu_torch.entry import demo_case
    from mt_renderer_tpu_torch.render import device as dv

    t0 = time.perf_counter()
    demo = demo_case(device, instances=instances, subdiv=subdiv,
                     width=width, height=height, translucent=translucent,
                     cam_scale=cam_scale, pool_mode=pool_mode)
    vp = demo.view_proj()
    bones = demo.bone_mats(phase)
    maxc = dv.auto_maxc(demo.batch, vp, bones, width=width, height=height)
    taps = dv.auto_tap_tiles(demo.batch, vp, bones, width=width,
                             height=height)
    log(f"scene: {len(demo.batch.tris)} tris, {width}x{height}, "
        f"translucent={translucent}, cam_scale={cam_scale}, pool "
        f"{pool_mode}, maxc={maxc}, "
        f"tap_tiles={taps}, set-up {time.perf_counter() - t0:.1f} s")
    return dict(demo=demo, scene=demo.scene, vp=vp, bones=bones,
                maxc=maxc, taps=taps, width=width, height=height)


def compare_outputs(got, want, what: str) -> float:
    """Hold a raster's (z, ids, attrs[, tapidx]) against its plain
    version's: ids, coverage and tap addresses equal in every layer, z
    and the attribute planes within ULP_TOL. Returns the max abs
    error."""
    zk, ik, tk = got[:3]
    zp, ip, tp = want[:3]
    n_id = [int((ik[:, i] != ip[:, i]).sum()) for i in range(ik.shape[1])]
    n_cov = [int(((ik[:, i] >= 0) != (ip[:, i] >= 0)).sum())
             for i in range(ik.shape[1])]
    n_tap = int((got[3] != want[3]).sum()) if len(got) > 3 else 0
    z_ulp = int(ulp_dist(zk, zp).max())
    t_ulp = int(ulp_dist(tk, tp).max())
    max_err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want))
    cov = [round(float((ip[:, i] >= 0).float().mean()), 4)
           for i in range(ip.shape[1])]
    log(f"{what}: coverage per layer {cov}; id mismatches per layer "
        f"{n_id}, coverage mismatches per layer {n_cov}, tapidx "
        f"mismatches {n_tap}, z max ulp {z_ulp}, attrs max ulp {t_ulp}, "
        f"max_abs_err {max_err!r}")
    if any(n_id) or any(n_cov) or n_tap or z_ulp > ULP_TOL \
            or t_ulp > ULP_TOL:
        raise AssertionError(f"{what}: the kernel disagrees with its plain "
                             "version")
    return max_err


def phase_kernel(case: dict) -> dict:
    """K1 against its plain version on the same inputs at the case's
    shapes."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = case["width"], case["height"]
    pw, ph = dv._padded(w, h)
    scene = case["scene"]
    clip = dv.vertex_stage(scene, case["vp"], case["bones"])
    cols, bbox = dv.setup_packed_cols(scene, clip, w, h)
    lists, glists, counts, n_over = rs.prebin(
        cols, bbox, 0, 0, width=pw, height=ph, maxc=case["maxc"])
    args = (cols, lists, glists, counts, (0, 0))
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS)

    got = rs.raster_fwd(*args, **kw)
    want = rs.raster_fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    max_err = compare_outputs(
        got, want, f"K1 vs plain at {pw}x{ph}, {cols.shape[1]} tris, maxc="
        f"{lists.shape[1]}")
    if int(n_over):
        raise AssertionError(f"{int(n_over)} tiles over maxc at frame 0")

    kernel_ms = graph_ms(lambda: rs.raster_fwd(*args, **kw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_reference(*args, **kw))
    log(f"raster_kernel_ms {kernel_ms!r}")
    log(f"raster_plain_ms {plain_ms!r}")
    return dict(max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
                **k1_breakdown(args, kw, got, "headline, tap"))


def phase_golden(device) -> None:
    from mt_renderer_tpu_torch.entry import demo_case
    from mt_renderer_tpu_torch.render import device as dv

    want = np.load(GOLDEN)["color"]
    case = demo_case(device, instances=4, subdiv=2, width=96, height=96)
    got, _ = dv.render_frame(case.scene, case.view_proj(),
                             case.bone_mats(0.6), width=96, height=96)
    share, n_diff = golden_share(got.cpu().numpy(), want)
    log(f"golden fixture_scene_96: {share:.5f} of pixels off by > 1 "
        f"({n_diff} differ at all), limit {GOLDEN_SHARE}")
    if share > GOLDEN_SHARE:
        raise AssertionError("fixture golden fails the golden rule")


def phase_main(case: dict, mipmap: bool = False,
               lighting: bool = False) -> dict:
    """FRAMES frames of the single-layer production loop (mipmapped and
    lit as asked) → the K1 launch count of this run, coverage and frame
    times."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import engine as en
    from mt_renderer_tpu_torch.render import raster as rs

    what = "mip+light main path" if mipmap or lighting else "main path"
    metric = "mip_frame_ms" if mipmap or lighting else "frame_ms"
    w, h, demo = case["width"], case["height"], case["demo"]
    cam = demo.camera
    frames = FRAMES
    base_yaw = cam.yaw
    eng = en.FrameEngine(demo.scene, demo.batch, width=w, height=h,
                         mipmap=mipmap, lighting=lighting)
    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"{rs.OVERFLOW_EVENTS} overflow events "
                             f"before the {what}")
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(frames + 1)]
    per_frame = []
    t0 = time.perf_counter()
    reset_launches()
    ev[0].record()
    for t in range(frames):
        before = rs.raster_fwd.launches
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        vp = demo.view_proj()
        bones = demo.bone_mats(0.3 * t)
        color, depth = eng.render(vp, bones)
        per_frame.append(rs.raster_fwd.launches - before)
        if t == 0:
            first = (color, depth, vp, bones, eng.maxc, eng.tap_tiles)
        ev[t + 1].record()
    ev[-1].synchronize()
    launches = rs.raster_fwd.launches
    wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    cam.yaw = base_yaw
    eng.check()
    rs.flush_overflow_checks()
    log(f"{what}: {frames} frames, K1 launches {launches}, overflow "
        f"events {rs.OVERFLOW_EVENTS}, caps maxc={eng.maxc} "
        f"tap_tiles={eng.tap_tiles}, recoveries {eng.recoveries}")
    if min(per_frame) < 1:
        raise AssertionError(f"a frame launched no K1: {per_frame}")
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"overflow on the {what}")

    color0, depth0, vp0, bones0, maxc0, taps0 = first
    if (tuple(color0.shape) != (h, w) or color0.dtype != torch.int32
            or tuple(depth0.shape) != (h, w)
            or not bool(torch.isfinite(depth0).all())):
        raise AssertionError(f"frame 0 malformed: {color0.dtype} "
                             f"{tuple(color0.shape)}")
    coverage = float((depth0 < 1.0).float().mean())
    plain, _, _ = dv._render_frame_core(
        case["scene"], vp0, bones0, width=w, height=h,
        clear_color=(255, 255, 255, 255), maxc=maxc0, tap_tiles=taps0,
        mipmap=mipmap, lighting=lighting, raster=rs.raster_fwd_reference)
    share, n_diff = golden_share(dv.unpack_rgba(color0),
                                 dv.unpack_rgba(plain))
    log(f"{what} frame 0 vs plain raster: {share:.6f} of pixels off by > "
        f"1, {n_diff} pixels differ; coverage {coverage:.4f}")
    if share > GOLDEN_SHARE or not 0.0 < coverage < 1.0:
        raise AssertionError(f"{what} frame 0 is wrong")
    per = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    frame_ms = ev[0].elapsed_time(ev[-1]) / frames
    log(f"{metric} {frame_ms!r} (CUDA events over {frames} frames; host "
        f"clock {wall_ms!r} ms/frame); per frame: median "
        f"{float(np.median(per))!r}, max {max(per)!r}, frame 0 {per[0]!r}")
    return dict(launches=launches, coverage=coverage, frame_ms=frame_ms)


def phase_ml_kernel(glass: dict, opaque: dict) -> dict:
    """K2 against its plain version: on the glass headline as the split
    peel calls it (translucent set, no opaque cull, K1's opaque z-buffer
    as ``zhi``), and with the opaque cull on the opaque headline."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = glass["width"], glass["height"]
    pw, ph = dv._padded(w, h)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS)
    scene = glass["scene"]
    clip = dv.vertex_stage(scene, glass["vp"], glass["bones"])
    (cols_op, bbox_op), (cols_tr, bbox_tr) = dv.setup_packed_cols(
        scene, clip, w, h, opacity_split=True)
    pre = rs.prebin(cols_op, bbox_op, 0, 0, width=pw, height=ph,
                    maxc=glass["maxc"])
    zo, io, _, _ = rs.raster_fwd(cols_op, *pre[:3], (0, 0), **kw)
    zhi = torch.where(io >= 0, zo, float("inf"))
    lists, glists, counts, n_over = rs.prebin(
        cols_tr, bbox_tr, 0, 0, width=pw, height=ph, maxc=glass["maxc"])
    if int(n_over) or int(pre[3]):
        raise AssertionError("glass frame 0 overflows maxc")
    args = (cols_tr, lists, glists, counts, (0, 0))
    mlkw = dict(kw, layers=LAYERS, opaque_cull=False, zhi=zhi)
    got = rs.raster_fwd_ml(*args, **mlkw)
    want = rs.raster_fwd_ml_reference(*args, **mlkw)
    torch.cuda.synchronize()
    err = compare_outputs(
        got, want, f"K2 vs plain, glass headline {pw}x{ph}, translucent "
        f"set, nocull + zhi, L={LAYERS}, maxc={lists.shape[1]}")
    kernel_ms = graph_ms(lambda: rs.raster_fwd_ml(*args, **mlkw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_ml_reference(*args, **mlkw),
                       warmup=1, reps=5)
    log(f"raster_ml_kernel_ms {kernel_ms!r}")
    log(f"raster_ml_plain_ms {plain_ms!r}")
    bnd = k2_breakdown(args, mlkw, got, "glass headline, tap, nocull + zhi")
    del got, want

    scene = opaque["scene"]
    cols, bbox = dv.setup_packed_cols(
        scene, dv.vertex_stage(scene, opaque["vp"], opaque["bones"]), w, h)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=opaque["maxc"])
    args = (cols, lists, glists, counts, (0, 0))
    mlkw = dict(kw, layers=LAYERS, opaque_cull=True)
    got = rs.raster_fwd_ml(*args, **mlkw)
    err = max(err, compare_outputs(
        got, rs.raster_fwd_ml_reference(*args, **mlkw),
        f"K2 vs plain, opaque headline, full (opaque cull), L={LAYERS}"))
    full_ms = graph_ms(lambda: rs.raster_fwd_ml(*args, **mlkw))
    full = k2_breakdown(args, mlkw, got, "opaque headline, tap, full")
    log(f"raster_ml_kernel_ms, opaque headline, full: {full_ms!r} (bound "
        f"{full['bound_ms']!r}, {full['bound_by']})")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, **bnd)


def split_equals_ml(case: dict, layers: int, what: str,
                    mipmap: bool = False, lighting: bool = False) -> int:
    """The split peel (packed, caps measured for it) against the ml peel
    (unpacked, dense), color and depth bit for bit: the reference's
    ``peel_split`` verify leg. → K2's launches in the ml peel's frame
    (its ``full`` path), counted from 0."""
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    kw = dict(width=case["width"], height=case["height"], layers=layers,
              maxc=case["maxc"], lighting=lighting)
    caps = dv.measure_live_tap_tiles(case["scene"], case["vp"],
                                     case["bones"], mode="split", **kw)
    kw["mipmap"] = mipmap
    sc, sd = dv.render_frame_peeled(case["scene"], case["vp"],
                                    case["bones"], peel_mode="split",
                                    packed=True, tap_tiles=caps, **kw)
    reset_launches()
    mc, md = dv.render_frame_peeled(case["scene"], case["vp"],
                                    case["bones"], peel_mode="ml", **kw)
    launches = rs.raster_fwd_ml.launches
    rs.flush_overflow_checks()
    n_color = int((dv.unpack_rgba(sc) != mc.cpu().numpy()).any(-1).sum())
    n_depth = int((sd != md).sum())
    cover = float((md < 1.0).float().mean())
    log(f"split vs ml, {what}, L={layers}, split caps {caps}: {n_color} "
        f"pixels differ in color, {n_depth} in depth; coverage {cover:.4f}")
    if n_color or n_depth or not 0.0 < cover or rs.OVERFLOW_EVENTS:
        raise AssertionError(f"split peel differs from ml peel ({what})")
    if launches < 1:
        raise AssertionError(f"the ml peel launched no K2 ({what})")
    return launches


def phase_split_vs_ml(device, opaque: dict) -> None:
    leg = headline_case(device, **VERIFY_LEG, phase=0.6)
    split_equals_ml(leg, 3, "verify-leg size 256x256, 9 instances")
    split_equals_ml(opaque, LAYERS, "opaque headline")


def phase_peel_main(glass: dict, mipmap: bool = False,
                    lighting: bool = False) -> dict:
    """FRAMES frames of the glass production loop (split peel, L=4,
    mipmapped and lit as asked) → the K1 and K2 launch counts of this
    run and frame times."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import engine as en
    from mt_renderer_tpu_torch.render import raster as rs

    what = ("peeled mip+light glass main path" if mipmap or lighting
            else "glass main path")
    metric = "peel_mip_frame_ms" if mipmap or lighting else "peel_frame_ms"
    w, h, demo = glass["width"], glass["height"], glass["demo"]
    cam = demo.camera
    frames = FRAMES
    base_yaw = cam.yaw
    eng = en.FrameEngine(demo.scene, demo.batch, width=w, height=h,
                         peel=LAYERS, peel_mode="split", mipmap=mipmap,
                         lighting=lighting)
    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"{rs.OVERFLOW_EVENTS} overflow events "
                             f"before the {what}")
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(frames + 1)]
    per_frame = []
    t0 = time.perf_counter()
    reset_launches()
    ev[0].record()
    for t in range(frames):
        before = (rs.raster_fwd.launches, rs.raster_fwd_ml.launches)
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        vp = demo.view_proj()
        bones = demo.bone_mats(0.3 * t)
        color, depth = eng.render(vp, bones)
        per_frame.append((rs.raster_fwd.launches - before[0],
                          rs.raster_fwd_ml.launches - before[1]))
        if t == 0:
            first = (color, depth, vp, bones, eng.maxc, eng.tap_tiles)
        ev[t + 1].record()
    ev[-1].synchronize()
    k1, k2 = rs.raster_fwd.launches, rs.raster_fwd_ml.launches
    wall_ms = (time.perf_counter() - t0) * 1e3 / frames
    cam.yaw = base_yaw
    eng.check()
    rs.flush_overflow_checks()
    log(f"{what}: {frames} frames, K1 launches {k1}, K2 launches "
        f"{k2} (per frame {per_frame}), overflow events "
        f"{rs.OVERFLOW_EVENTS}, caps maxc={eng.maxc} "
        f"tap_tiles={eng.tap_tiles}, recoveries {eng.recoveries}")
    if any(a < 1 or b < 1 for a, b in per_frame):
        raise AssertionError(f"a frame of the {what} launched no K1 or no "
                             "K2")
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"overflow on the {what}")

    color0, depth0, vp0, bones0, maxc0, taps0 = first
    if (tuple(color0.shape) != (h, w) or color0.dtype != torch.int32
            or tuple(depth0.shape) != (h, w)
            or not bool(torch.isfinite(depth0).all())):
        raise AssertionError(f"{what} frame 0 malformed: {color0.dtype} "
                             f"{tuple(color0.shape)}")
    coverage = float((depth0 < 1.0).float().mean())
    plain, _, _ = dv._render_frame_peeled_core(
        glass["scene"], vp0, bones0, width=w, height=h, layers=LAYERS,
        clear_color=(255, 255, 255, 255), maxc=maxc0, peel_mode="split",
        tap_tiles=taps0, mipmap=mipmap, lighting=lighting,
        raster=rs.raster_fwd_reference,
        raster_ml=rs.raster_fwd_ml_reference)
    share, n_diff = golden_share(dv.unpack_rgba(color0),
                                 dv.unpack_rgba(plain))
    log(f"{what} frame 0 vs plain rasters: {share:.6f} of pixels off by "
        f"> 1, {n_diff} pixels differ; coverage {coverage:.4f}")
    if share > GOLDEN_SHARE or not 0.0 < coverage <= 1.0:
        raise AssertionError(f"{what} frame 0 is wrong")
    per = [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]
    frame_ms = ev[0].elapsed_time(ev[-1]) / frames
    log(f"{metric} {frame_ms!r} (CUDA events over {frames} frames; "
        f"host clock {wall_ms!r} ms/frame); per frame: median "
        f"{float(np.median(per))!r}, max {max(per)!r}, frame 0 {per[0]!r}")
    return dict(k1=k1, k2=k2, frame_ms=frame_ms)


def with_normals(batch):
    """A copy of ``batch`` with unit normals pointing away from its
    centroid: the demo scene carries none, so its lambert factor is the
    0.3 floor everywhere; with these it varies."""
    out = copy.copy(batch)
    c = batch.positions - batch.positions.mean(0)
    out.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return out


def phase_mip_kernel(case: dict) -> dict:
    """K1's mtap + lit epilogues against their plain version at the
    mip+light headline, and on the same scene with unit normals."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = case["width"], case["height"]
    pw, ph = dv._padded(w, h)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode="mtap",
              light=dv._light_unit())
    err = 0.0
    for what, scene in (
            ("headline (no normals: the 0.3 floor)", case["scene"]),
            ("headline with unit normals",
             dv.upload(with_normals(case["demo"].batch), "tri",
                       device=case["scene"].device))):
        clip = dv.vertex_stage(scene, case["vp"], case["bones"])
        cols, bbox = dv.setup_packed_cols(scene, clip, w, h,
                                          bone_mats=case["bones"],
                                          lighting=True)
        lists, glists, counts, n_over = rs.prebin(
            cols, bbox, 0, 0, width=pw, height=ph, maxc=case["maxc"])
        args = (cols, lists, glists, counts, (0, 0))
        got = rs.raster_fwd(*args, **kw)
        want = rs.raster_fwd_reference(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare_outputs(
            got, want, f"K1 mtap+lit vs plain, {what}, {pw}x{ph}, "
            f"{cols.shape[0]}-row lit matrix"))
        if int(n_over):
            raise AssertionError("mip+light frame 0 overflows maxc")
        if scene is case["scene"]:
            kernel_ms = graph_ms(lambda: rs.raster_fwd(*args, **kw))
            plain_ms = cuda_ms(lambda: rs.raster_fwd_reference(*args, **kw))
            bnd = k1_breakdown(args, kw, got,
                               "mip+light headline, mtap + lit")
    log(f"raster_mtap_lit_kernel_ms {kernel_ms!r}")
    log(f"raster_mtap_lit_plain_ms {plain_ms!r}")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, **bnd)


def phase_ml_mip_kernel(glass: dict, opaque: dict) -> tuple:
    """K2's mtap + lit epilogues against their plain version: at the
    glass headline with the tri pool as the split peel calls it (the
    translucent set, no opaque cull, K1's opaque z-buffer as ``zhi``),
    and at the opaque mip+light headline as the ml peel calls it (every
    triangle, the opaque cull); L = LAYERS, both timed, each with its
    breakdown → (glass reading, opaque reading)."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = glass["width"], glass["height"]
    pw, ph = dv._padded(w, h)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode="mtap",
              light=dv._light_unit())
    lit = dict(bone_mats=glass["bones"], lighting=True)
    scene = glass["scene"]
    clip = dv.vertex_stage(scene, glass["vp"], glass["bones"])
    (cols_op, bbox_op), (cols_tr, bbox_tr) = dv.setup_packed_cols(
        scene, clip, w, h, opacity_split=True, **lit)
    pre = rs.prebin(cols_op, bbox_op, 0, 0, width=pw, height=ph,
                    maxc=glass["maxc"])
    zo, io = rs.raster_fwd(cols_op, *pre[:3], (0, 0), **kw)[:2]
    zhi = torch.where(io >= 0, zo, float("inf"))
    lists, glists, counts, n_over = rs.prebin(
        cols_tr, bbox_tr, 0, 0, width=pw, height=ph, maxc=glass["maxc"])
    if int(n_over) or int(pre[3]):
        raise AssertionError("glass frame 0 overflows maxc")
    args = (cols_tr, lists, glists, counts, (0, 0))
    mlkw = dict(kw, layers=LAYERS, opaque_cull=False, zhi=zhi)
    got = rs.raster_fwd_ml(*args, **mlkw)
    want = rs.raster_fwd_ml_reference(*args, **mlkw)
    torch.cuda.synchronize()
    err = compare_outputs(
        got, want, f"K2 mtap+lit vs plain, glass headline (tri pool) "
        f"{pw}x{ph}, translucent set, nocull + zhi, L={LAYERS}, "
        f"{cols_tr.shape[0]}-row lit matrix")
    bnd = k2_breakdown(args, mlkw, got,
                       "glass headline (tri pool), mtap + lit, nocull + zhi")
    del got, want
    kernel_ms = graph_ms(lambda: rs.raster_fwd_ml(*args, **mlkw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_ml_reference(*args, **mlkw),
                       warmup=1, reps=5)
    log(f"raster_ml_mtap_lit_kernel_ms {kernel_ms!r}")
    log(f"raster_ml_mtap_lit_plain_ms {plain_ms!r}")

    scene = opaque["scene"]
    cols, bbox = dv.setup_packed_cols(
        scene, dv.vertex_stage(scene, opaque["vp"], opaque["bones"]), w, h,
        bone_mats=opaque["bones"], lighting=True)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=opaque["maxc"])
    args = (cols, lists, glists, counts, (0, 0))
    mlkw = dict(kw, layers=LAYERS, opaque_cull=True)
    got = rs.raster_fwd_ml(*args, **mlkw)
    want = rs.raster_fwd_ml_reference(*args, **mlkw)
    torch.cuda.synchronize()
    full_err = compare_outputs(
        got, want, f"K2 mtap+lit vs plain, opaque mip+light headline, full "
        f"(opaque cull), L={LAYERS}")
    del want
    full_bnd = k2_breakdown(args, mlkw, got,
                            "opaque mip+light headline, mtap + lit, full")
    del got
    full_ms = graph_ms(lambda: rs.raster_fwd_ml(*args, **mlkw))
    full_plain_ms = cuda_ms(
        lambda: rs.raster_fwd_ml_reference(*args, **mlkw), warmup=1, reps=3)
    log(f"raster_ml_mtap_lit_kernel_ms, opaque mip+light headline, full: "
        f"{full_ms!r} (plain {full_plain_ms!r})")
    return (dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, **bnd),
            dict(max_abs_err=full_err, ms=full_ms, plain_ms=full_plain_ms,
                 **full_bnd))


def phase_world_legs(device) -> None:
    """The reference bench's world verify legs on the card."""
    from mt_renderer_tpu_torch import verify
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    r = verify.world_legs(device)
    log(f"world verify legs, 256x144, {r['materials']} materials, "
        f"{r['tris']} tris ({time.perf_counter() - t0:.1f} s): "
        + json.dumps({k: v for k, v in r.items() if isinstance(v, dict)}))
    if not r["passed"] or rs.OVERFLOW_EVENTS:
        raise AssertionError("a world verify leg failed")


def phase_world_main(device) -> dict:
    """FRAMES frames of the full world (the bench's ``pallas world`` row:
    280 buildings, the tri pool, mipmapped, 1920x1080), the caps sized at
    frame 0 as the bench sizes them, the yaw varying as in phase 5 and
    each frame's palette computed on the card (``bone_mats_device`` at
    scheduler frame 2t). Frame 0 is rendered from the host palette too:
    palette and frame must agree bit for bit. K1 (mtap, unlit) is held
    against its plain version on frame 0's inputs. → K1's launch count
    of the loop, its record and frame times."""
    import torch

    from mt_renderer_tpu_torch.entry import world_case
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    case = world_case(device, pool_mode="tri", **WORLD)
    w, h, cam = case.width, case.height, case.camera
    base_yaw = cam.yaw
    vp0, host_pal = case.view_proj(), case.bone_mats(0.0)
    maxc = dv.auto_maxc(case.batch, vp0, host_pal, width=w, height=h)
    taps = dv.auto_tap_tiles(case.batch, vp0, host_pal, width=w, height=h)
    log(f"world: {case.world.info}, {w}x{h}, pool tri "
        f"({case.scene.mip_pool.shape[0]} rows of 128 B), maxc={maxc}, "
        f"tap_tiles={taps}, set-up {time.perf_counter() - t0:.1f} s")
    fkw = dict(width=w, height=h, mipmap=True, packed=True, maxc=maxc,
               tap_tiles=taps)

    dev_pal = case.bone_mats_device(0.0)
    pal_err = float((dev_pal.cpu() - torch.from_numpy(host_pal)).abs().max())
    a, ad = dv.render_frame(case.scene, vp0, dev_pal, **fkw)
    b, bd = dv.render_frame(case.scene, vp0, host_pal, **fkw)
    n_px = int((a != b).sum())
    log(f"world frame 0, card palette vs host palette: palette max abs "
        f"diff {pal_err!r}, {n_px} pixels differ, depth equal "
        f"{bool(torch.equal(ad, bd))}; coverage "
        f"{float((ad < 1.0).float().mean()):.4f}")
    if pal_err > 1e-5 or n_px or not torch.equal(ad, bd):
        raise AssertionError("the card's palette changes the world frame")

    pw, ph = dv._padded(w, h)
    cols, bbox = dv.setup_packed_cols(
        case.scene, dv.vertex_stage(case.scene, vp0, dev_pal), w, h)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=maxc)
    args = (cols, lists, glists, counts, (0, 0))
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode="mtap")
    got = rs.raster_fwd(*args, **kw)
    want = rs.raster_fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    err = compare_outputs(got, want, f"K1 mtap vs plain, world frame 0, "
                          f"{cols.shape[1]} tris, maxc={lists.shape[1]}")
    bnd = k1_breakdown(args, kw, got, "world frame 0, mtap")
    del got, want
    kernel_ms = graph_ms(lambda: rs.raster_fwd(*args, **kw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_reference(*args, **kw),
                       warmup=1, reps=5)
    log(f"raster_world_mtap_kernel_ms {kernel_ms!r}")
    log(f"raster_world_mtap_plain_ms {plain_ms!r}")
    del args, cols, lists, glists, counts

    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"{rs.OVERFLOW_EVENTS} overflow events before "
                             "the world main path")
    dur = max(case.world.timeline.duration, 1)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(FRAMES + 1)]
    per_frame = []
    t0 = time.perf_counter()
    reset_launches()
    ev[0].record()
    for t in range(FRAMES):
        before = rs.raster_fwd.launches
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        color, depth = dv.render_frame(
            case.scene, case.view_proj(),
            case.bone_mats_device((2.0 * t) % dur), **fkw)
        per_frame.append(rs.raster_fwd.launches - before)
        ev[t + 1].record()
    ev[-1].synchronize()
    launches = rs.raster_fwd.launches
    wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    cam.yaw = base_yaw
    rs.flush_overflow_checks()
    coverage = float((depth < 1.0).float().mean())
    log(f"world main path: {FRAMES} frames, K1 launches {launches}, "
        f"overflow events {rs.OVERFLOW_EVENTS}; last frame coverage "
        f"{coverage:.4f}")
    if min(per_frame) < 1 or rs.OVERFLOW_EVENTS:
        raise AssertionError("a world frame launched no K1, or overflowed")
    if (tuple(color.shape) != (h, w) or color.dtype != torch.int32
            or not 0.0 < coverage <= 1.0):
        raise AssertionError("the last world frame is malformed")
    per = [x.elapsed_time(y) for x, y in zip(ev[:-1], ev[1:])]
    frame_ms = ev[0].elapsed_time(ev[-1]) / FRAMES
    log(f"world_frame_ms {frame_ms!r} (CUDA events over {FRAMES} frames; "
        f"host clock {wall_ms!r} ms/frame); per frame: median "
        f"{float(np.median(per))!r}, max {max(per)!r}, frame 0 {per[0]!r}")
    return dict(launches=launches, frame_ms=frame_ms, max_abs_err=err,
                ms=kernel_ms, plain_ms=plain_ms, **bnd)


def micro_check(chunk, what: str) -> tuple:
    """K3 (every row of the card's grid, 4 reps) against its plain
    version on one chunk's columns → (max abs error, coverage); raises
    if any row differs."""
    import torch

    from mt_renderer_tpu_torch.render import raster as rs

    got = rs.raster_micro(chunk, 4, rs.N_COEF)
    want = rs.raster_micro_reference(chunk, 4, rs.N_COEF)
    torch.cuda.synchronize()
    rows = got[0].shape[0]
    n_bad = sum(int((g != w.expand_as(g)).any(-1).any(-1).sum())
                for g, w in zip(got, want))
    cover = float((want[1] >= 0).float().mean())
    err = max(float(torch.where(torch.isfinite(w), g - w, 0).abs().max())
              for g, w in ((got[0], want[0]), (got[2], want[2])))
    log(f"K3 vs plain, {what}, 4 reps, {rows} rows of {rs.PARTS} CTAs "
        f"({rs.blocks_per_sm(chunk.device)} CTAs per SM): {n_bad} rows "
        f"differ; coverage {cover:.4f}, max_abs_err {err!r}")
    if n_bad:
        raise AssertionError(f"K3 disagrees with its plain version ({what})")
    return err, cover


def phase_micro(case: dict) -> dict:
    """K3 against its plain version on chunk 0 of the headline setup
    (it covers nothing of the probe's tile: the cull tests alone), on
    chunk 0 of the 4-instance demo scene at 128x16 (which covers part of
    it) and on the roofline's full-cover chunk (every triangle covers
    all of it); then the full grid (``raster.card_rows``, K1's
    occupancy) on the full-cover chunk, timed at MICRO_REPS reps against
    the plain version of the same rows, and priced on that grid's work:
    per rep and row 12 x WARPS cull tests of 32 triangles (CULL_OPS
    each) and the surviving (triangle, warp) pairs' 256 pixels
    (PLANE_OPS each)."""
    from mt_renderer_tpu_torch.render import raster as rs
    from mt_renderer_tpu_torch.tools import raster_roofline as rr

    chunk = rr.chunk0(case["scene"], case["vp"], case["bones"],
                      case["width"], case["height"])
    err, _ = micro_check(chunk, "chunk 0 of the headline")
    err_s, cover = micro_check(rr.covering_chunk(chunk.device),
                               "chunk 0 of 4 instances at 128x16")
    cover_chunk = rr.full_cover_chunk(chunk.device)
    err_d, cover_d = micro_check(cover_chunk, "the full-cover chunk")
    if not min(cover, cover_d) > 0.0:
        raise AssertionError("K3's covering check covers no pixel")
    rows = rs.card_rows(chunk.device)
    surv = rr.probe_surviving(cover_chunk)
    kernel_ms = cuda_ms(lambda: rs.raster_micro(cover_chunk, MICRO_REPS,
                                                rs.N_COEF))

    def plain():
        return [x.expand(rows, -1, -1).contiguous()
                for x in rs.raster_micro_reference(cover_chunk, MICRO_REPS,
                                                   rs.N_COEF)]

    plain_ms = cuda_ms(plain, warmup=1, reps=5)
    log(f"raster_micro_kernel_ms ({rows} rows, {MICRO_REPS} reps, full-"
        f"cover chunk, {surv} surviving (triangle, warp) a rep) "
        f"{kernel_ms!r}")
    log(f"raster_micro_plain_ms (one row, broadcast to {rows}) {plain_ms!r}")
    out_bytes = rows * rs.P * 4 * (2 + rs.N_COEF)
    ops = rows * MICRO_REPS * (rs.G * rs.WARPS * rs.KG * CULL_OPS
                               + surv * rs.WARP_W * rs.WARP_H * PLANE_OPS)
    return dict(max_abs_err=max(err, err_s, err_d), ms=kernel_ms,
                plain_ms=plain_ms,
                rows=rows, surviving=surv,
                **bound(nbytes(cover_chunk) + out_bytes, ops))


def phase_roofline(device) -> dict:
    """The roofline path on its default preset, shortened to 2 views and
    3 repeats → K3's launch count of this run and the readings (K3's two
    rates among them); then the world preset, 8 views, priced at the
    default's rates."""
    from mt_renderer_tpu_torch.render import raster as rs
    from mt_renderer_tpu_torch.tools import raster_roofline

    reset_launches()
    r = raster_roofline.roofline("default", device, views=2, repeats=3)
    launches = rs.raster_micro.launches
    log(f"roofline path: K3 launches {launches}, K1 launches "
        f"{rs.raster_fwd.launches}")
    log(raster_roofline.rates_line(r["sol"]))
    log(raster_roofline.summary_line(r))
    if (launches < 1 or not 0.0 < r["util"] < 10.0
            or not r["sol"]["eval_ns"] > 0.0):
        raise AssertionError("the roofline path did not run K3 or read "
                             "no utilization")
    world = raster_roofline.roofline("world", device, views=8, repeats=3,
                                     sol=r["sol"])
    log(raster_roofline.summary_line(world))
    if not 0.0 < world["util"] < 10.0:
        raise AssertionError("the world roofline read no utilization")
    return dict(launches=launches, **r)


def phase_bilin(device) -> dict:
    """K4 against its plain version bit for bit at bilin_ab.ROWS rows;
    then the bilinear A/B path → K4's launch count and the forms'
    times."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.tools import bilin_ab

    _, pool_u32, idx, f = bilin_ab.probe_inputs(device, sets=1)
    got = dv.bilin_swar(pool_u32, idx[0], f[0, 0], f[1, 0])
    want = dv.bilin_swar_reference(pool_u32, idx[0], f[0, 0], f[1, 0])
    torch.cuda.synchronize()
    # the pool, the rows' index and fractions, the output; 4 f32 ops a
    # row for the two 8-bit weights
    bnd = bound(nbytes(pool_u32, idx[0], f[0, 0], f[1, 0], got),
                4 * idx.shape[1])
    n_diff = int((got != want).sum())
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    log(f"K4 vs plain at {bilin_ab.ROWS} rows: {n_diff} rows differ, "
        f"max_abs_err {err!r}")
    if n_diff:
        raise AssertionError("K4 disagrees with its plain version")
    del got, want, idx, f
    reset_launches()
    res = bilin_ab.timings(device, repeats=3)
    launches = dv.bilin_swar.launches
    log(f"bilinear A/B path: K4 launches {launches}; ms per set of "
        f"{bilin_ab.ROWS} rows: {json.dumps(res)}")
    if launches < 1:
        raise AssertionError("the bilinear A/B path did not run K4")
    return dict(launches=launches, max_abs_err=err, ms=res["swar-kernel"],
                plain_ms=res["swar"], forms=res, **bnd)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import mt_renderer_tpu_torch  # noqa: F401  (sets fp32 matmul rules)

    dev_info = phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    case = headline_case(device, **HEADLINE)
    k1 = phase_kernel(case)
    phase_golden(device)
    main_run = phase_main(case)
    glass = headline_case(device, **GLASS)
    k2 = phase_ml_kernel(glass, case)
    phase_split_vs_ml(device, case)
    peel_run = phase_peel_main(glass)
    del glass
    mip = headline_case(device, **MIP)
    k1_mip = phase_mip_kernel(mip)
    mip_run = phase_main(mip, mipmap=True, lighting=True)
    glass_mip = headline_case(device, **GLASS_MIP)
    k2_mip, k2_full = phase_ml_mip_kernel(glass_mip, mip)
    full_launches = split_equals_ml(mip, LAYERS, "opaque mip+light headline",
                                    mipmap=True, lighting=True)
    peel_mip_run = phase_peel_main(glass_mip, mipmap=True, lighting=True)
    del glass_mip, mip
    phase_world_legs(device)
    world_run = phase_world_main(device)
    k3 = phase_micro(case)
    roof = phase_roofline(device)
    k4 = phase_bilin(device)
    from mt_renderer_tpu_torch.tools import raster_roofline

    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")

    def record(name, source, replaces, launches, reading, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    **{k: reading[k] for k in fields}, library_ms=None,
                    **extra)

    sol = roof["sol"]

    def raster_record(name, variant, launches, reading):
        # K1 and K2: their cull tests and survivors; the floor leaves out
        # K2's insertions
        k1 = name == "raster_fwd"
        extra = (dict(nowin_ms=reading["nowin_ms"]) if k1
                 else dict(fill_ms=reading["fill_ms"]))
        return record(name, KERNEL_SOURCE if k1 else ML_KERNEL_SOURCE,
                      KERNEL_REPLACES if k1 else ML_KERNEL_REPLACES,
                      launches, reading, variant=variant,
                      pairs=reading["pairs"], surviving=reading["surviving"],
                      binned_bound_ms=reading["binned_bound_ms"],
                      empty_ms=reading["empty_ms"], **extra,
                      floor_ms=raster_roofline.floor_ms(
                          reading["pairs"], reading["surviving"], sol))

    records = [
        raster_record("raster_fwd", "tap", main_run["launches"], k1),
        raster_record("raster_fwd", "mtap+lit", mip_run["launches"], k1_mip),
        raster_record("raster_fwd", "mtap (world)", world_run["launches"],
                      world_run),
        raster_record("raster_fwd_ml", "tap", peel_run["k2"], k2),
        raster_record("raster_fwd_ml", "mtap+lit", peel_mip_run["k2"],
                      k2_mip),
        raster_record("raster_fwd_ml",
                      "full (opaque mip+light headline, ml peel)",
                      full_launches, k2_full),
        record("raster_micro", MICRO_SOURCE, MICRO_REPLACES,
               roof["launches"], k3, rows=k3["rows"],
               surviving=k3["surviving"], test_ns=sol["test_ns"],
               eval_ns=sol["eval_ns"]),
        record("bilin_swar", SWAR_SOURCE, SWAR_REPLACES, k4["launches"], k4),
    ]
    for rec in records:
        for v in (rec["max_abs_err"], rec["ms"], rec["plain_ms"],
                  rec["bound_ms"]):
            if not math.isfinite(v):
                raise AssertionError(f"non-finite reading in {rec}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
