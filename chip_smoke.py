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
posed on the card: the ``pallas world`` row); the two probe tools'
paths, shortened: ``tools.raster_roofline`` on its ``default`` and
``world`` presets and ``tools.bilin_ab``; the split frames of
``parallel``: the band split, the geometry split and two processes over
gloo, each on slots of the one card; the multipass peel of the glass and
the peeled mip+light headlines (K1's ``zlow`` and ``attrs`` variants,
through ``render_frame_peeled`` and ``FrameEngine``); and the scan
backend at 1920x1080. Phases, each of which raises on failure:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build K1 (``csrc/raster_fwd.cu``), K2 (``csrc/raster_fwd_ml.cu``),
   K3 (``csrc/raster_micro.cu``), K4 (``csrc/bilin_swar.cu``) and the
   bc7 trilinear sample (``csrc/bc7_trilinear.cu``), every ``nvcc``
   process at once, and print ptxas' register, shared memory
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
   (p1) the glass headline's multipass peel, L = 4, through
   ``render_frame_peeled(peel_mode="multipass")`` with the launch counts
   set to 0 just before it: K1 launched 4 times (tap; tap + zlow on
   passes 1-3); every pass of the same frame recorded and equal, bit for
   bit, to K1's plain version on its own inputs; the frame against the
   ml peel at L = 4 (coverage exact, the golden rule); K1 + zlow on
   pass 1's inputs timed against its plain version, with its breakdown;
   (p3) 20 frames of ``FrameEngine(peel=4, peel_mode="multipass")`` on
   the glass headline as in phase 5: 4 K1 launches every frame, no
   overflow, the unpacked frame, frame 0 equal to
   ``render_frame_peeled``;
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
    (p2) the peeled mip+light headline's multipass peel as (p1): K1's
    attrs epilogue (lit, + zlow on passes 1-3), ``shade_fwd``, the
    plane-major composite;
12. the world's verify legs (``verify.world_legs``: 256x144, 130
    buildings): the invariants, the packed and the characters' frames
    against the NumPy oracle, the mipmapped frame against the scan
    backend's (the quad pool) and against the plain raster, the palette
    animating;
13. the world main path: 20 frames of the full world at 1920x1080 with
    the caps sized at frame 0 (as the reference bench sizes them), each
    frame's palette computed on the card by ``bone_mats_device``; frame
    0's palette and frame equal, bit for bit, to the host palette's; K1
    (mtap) against its plain version on frame 0's inputs;
14. (a) the world with the bc1 texel pool (``entry.world_case(
    pool_mode="bc1")``, its textures BC1-encoded through the port's
    ``native`` binding, whose state it prints): frame 0 equal, bit for
    bit, to the frame of a tri pool of its BC1-decoded chains; the
    ``pool_stats`` of the bc1, tri and quad world scenes; K1 (mtap)
    against its plain version on frame 0's inputs; 20 frames of
    ``FrameEngine(mipmap=True)`` with the palette on the card: K1 in
    every frame, no overflow;
15. (b) the glass headline with the bc1 pool, split peel L = 4,
    mipmapped and lit: equal, bit for bit, to the frame of a tri pool of
    its decoded chains; K2 (mtap + lit) against its plain version as
    that frame calls it, timed, with its breakdown;
16. (c) the narrow pool on the mip+light headline: its frame equals the
    quad pool's bit for bit, and its tap frame raises ``ValueError``;
17. (d) ``count_covered_textured`` on the headline equals the covered
    and textured counts of K1's outputs for that view;
    ``upload("auto", mipmap=True)`` under ``pool_budget_default`` (printed)
    picks the tri pool;
18. K3 against its plain version on a chunk that covers nothing of its
    tile and on two that cover it, then timed over the full grid; the
    roofline on ``default`` (2 views), whose rates line gives K3's two
    rates (ns per (group, warp) cull test, ns per surviving (triangle,
    warp)), and on ``world`` (8 views) at those rates; K4 against its
    plain version and the bilinear A/B;
19. (e) the world with the bc7 texel pool (``entry.world_case(
    pool_mode="bc7")``, mode-6 content): as (a), against a tri pool of
    its BC7-decoded chains, its ``pool_stats`` beside the bc1, tri and
    quad scenes' of (a), K1 (mtap) against its plain version, 20 frames
    of ``FrameEngine(mipmap=True)``;
20. (f) the same world's textures as seeded random BC7 blocks of all
    eight modes (``upload(pool_mode="bc7", bc7_chains=)``): every mode
    present and the hint pool built; frame 0 equal, bit for bit, to a tri
    pool of the decoded chains, the bc7 trilinear kernel launched; the
    bc7 trilinear kernel against its plain twin, bit for bit, on frame
    0's taps over every live row (the ``world_bc7.orbit`` loop's
    shapes), timed beside its byte bound and the twin's time;
21. (g) the glass headline with the bc7 pool as (b): its split peel
    L = 4, mip+light, equal to its decoded chains' frame, K2 (mtap + lit)
    against its plain version;
22. (h) the reference bench's verify legs on the card
    (``verify.bench_legs``: 256x256, 9 instances at subdiv 2): every leg
    passes, and each leg's readings are printed; (c2) among them the
    scan backend's ``scan`` and ``peel_scan`` legs against the NumPy
    oracle and ``mipmap_packed`` held against the scan backend's
    trilinear frame (the world's at phase 12 likewise);
    (c1) the scan backend at 1920x1080 on the demo scene at 64
    instances, subdiv 2 (3,072 triangles): single, ml-peeled (L = 4),
    mipmapped and lit frames, each against ``render_frame(backend=
    "pallas")`` (or its ml peel) under the golden rule with no coverage
    mismatch off the edge; the bc1 and the bc7 pool's frames without
    mipmap, each bit-equal to the scan frame of a quad pool of its
    decoded chains; the scan band split over 8 slots and the scan
    geometry split over 2 shards, each bit-equal to the scan frame;
23. the viewers at 1920x1080, each run through the CLI's ``main`` with
    the launch counts set to 0 just before it, every ``FrameEngine``
    frame watched (its K1 and K2 launches, the overflow its checks
    drain): (v1) ``modelviewer --demo 280 --hud --hud-gmd`` (the
    fixture GMD), 20 frames: K1 in every frame, no overflow, frame 0
    below the HUD band under the golden rule against the plain K1, the
    band equal, bit for bit, to the CPU composite of the same band onto
    the same frame; the HUD's host raster (as ``bench.py:555-567`` times
    it), the band composite's device time, ``encode_png`` of a frame, and
    K1 (mtap) against its plain version on frame 0's inputs; (v2) the
    bench's ``world+hud`` composite (its world, a joint cube at every
    character joint, the HUD band) through ``RendererAppManager``, 20
    frames, as (v1); (v3) the fixture tree's skinned character with ``--overlay
    --sdl --mipmap --lighting --peel 4``: K1 and K2 in every frame;
    (v4) ``--demo 40 --events`` with WASD and mouse: the camera after
    every frame equals the host-computed trajectory, and the frames
    change; (v5) ``--demo 40 --serve 0 --serve-frames 10`` with a client
    thread (``/frame.png`` decodes to 1920x1080, ``/stats``, ``POST
    /event`` reaches the input state); (v6) ``textureviewer`` on a
    2048x2048 RGBA ``.tex``, raw and YCbCr: the PNG equal, byte for byte,
    to the CPU run's, and ``view_texture``'s device time; (v7)
    ``sceneviewer`` on the fixture archive with the joint overlay;
24. (s1) the served headline: ``serving.export_render`` of the headline
    scene on the card (K1 as the custom op ``mtr::raster_fwd_tap``),
    ``load_render``, then 20 requests with yaw and bones varying as in
    phase 5, K1's launches counted from 0, the overflow queue drained (it
    must read 0); each served (color, depth) equal, bit for bit, to
    ``render_frame`` on the same inputs; the export and load times, the
    artifact's bytes, the served request's ms beside ``render_frame``'s
    (CUDA events, median of 20); K1 against its plain version on request
    0's inputs at the served program's ``maxc`` (256), with its breakdown;
25. (s2) the served mip headline (tri pool, ``export_render(mipmap=
    True)``, K1's mtap through ``mtr::raster_fwd_mtap``): 5 requests, each
    bit-equal to ``render_frame``;
26. (s3) one headline ``render_frame`` under ``utils.profiling.trace``:
    the Chrome trace must hold each ``frame.*`` span (vertex, setup,
    prebin, raster, shade, unflatten; each span's host ms printed) once
    as a ``user_annotation``, K1's ``raster_fwd_kernel`` once as a CUDA
    kernel event with a duration (printed beside K1's graph-replay ms),
    and K1's launching runtime call, matched by correlation id, inside
    ``frame.raster``'s host range;
27. (s4) ``makefixtures`` into a temporary directory, then the other nine
    dump/pack CLIs on that tree as processes started together, each
    exiting 0, and ``arctool pack`` and ``gmdtool rebuild`` giving back
    the archive's and the GMD's bytes;
28. (m1) the headline band split (``parallel.tiles.
    render_frame_multichip``) over n slots of the card for n in 1, 2, 3,
    8, packed with taps from ``auto_tap_tiles(bands=n)``: each frame
    bit-equal (color and depth) to ``render_frame``, K1 launched n times;
    8 bands unpacked and with ``setup_shard`` too; K1 against its plain
    version on band 4 of 8;
29. (m2) the world (280 buildings, mipmapped, palette on the card) in 8
    bands with the tri pool and with the bc7 pool, each bit-equal to its
    single-device frame; K1 (mtap) on band 4 of 8;
30. (m3) the glass headline's split peel, L = 4, in 8 bands with the cap
    pair from ``measure_live_tap_tiles(mode="split", bands=8)``,
    bit-equal to ``render_frame_peeled(peel_mode="split")``; K1 and K2
    launched 8 times; K2 against its plain version on band 4 of 8;
31. (m4) the headline's geometry split (``render_frame_geomsplit``) over
    2 and 4 slots, bit-equal to ``render_frame``; K1 on shard 0 of 4;
32. (m5) two processes sharing the card over a gloo group,
    ``mt_renderer_tpu_torch.tools.multihost_demo`` at the headline size:
    each rank's rows (packed, peeled, mipmapped, sharded setup) and the
    geometry split's frame bit-equal to its own single-device frame,
    ``gather_full_frame`` the whole frame, MULTIHOST OK twice;
33. (m6) ``entry.dryrun_multichip(8)`` on the card and the bench's
    ``multichip_1dev`` verify leg from (h).

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
the opaque mip+light headline's ml peel; K1 a fourth and a fifth, mtap
on the bc1 and the bc7 world's loops, and a sixth, mtap on the viewer's
(v1), and a seventh, tap on the served headline (s1), an eighth, a
ninth and a tenth on the split frames: tap on the headline's 8-band
frame (m1), mtap on the world's (m2), tap on the 4-shard geometry split
(m4), and an eleventh and a twelfth on the multipass peel: tap + zlow
((p1)'s pass 1, its launches those of (p3)'s 20 frames) and attrs +
zlow + lit ((p2)'s pass 1, its launches (p2)'s frame's); and K2 a fourth
and a fifth, mtap + lit on the bc1 and the bc7 glass headline's split
peel, and a sixth, tap on the 8-band split peel (m3); the bc7 trilinear
kernel's record from (f)) as one JSON line before the last, and as
its last line
``{"ok": true, "device": {...}}``.
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
BC7_SOURCE = "mt_renderer_tpu_torch/csrc/bc7_trilinear.cu"
BC7_REPLACES = "none (the JAX package decodes BC7 with jnp ops)"
BC7_TAP_BYTES = 232         # inputs 24, pool row 128, hint row 64, out 16
HEADLINE = dict(instances=1024, subdiv=4, width=1920, height=1080)
GLASS = dict(HEADLINE, translucent=True, cam_scale=0.3)
MIP = dict(HEADLINE, pool_mode="tri")
GLASS_MIP = dict(GLASS, pool_mode="tri")
WORLD = dict(buildings=280, building_subdivs=(4, 6, 8, 10, 12),
             width=1920, height=1080)       # the bench's world row
MICRO_REPS = 16             # reps of the timed probe against its twin
VERIFY_LEG = dict(instances=9, subdiv=2, width=256, height=256)
SCAN = dict(instances=64, subdiv=2, width=1920, height=1080)   # (c1)
VIEWER = dict(width=1920, height=1080)
VIEWER_WORLD = 280          # modelviewer --demo: the bench's world size
VIEWER_SMALL_WORLD = 40     # the --events and --serve runs
LAYERS = 4                  # the glass preset's peel depth
FRAMES = 20
SERVED_MIP = 5              # requests to the served mip headline
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


def frame_rgba(color, h: int, w: int, what: str) -> np.ndarray:
    """A frame in either format a ``FrameEngine`` returns (the (H, W)
    int32 packed frame, or a peeled mip frame's (H, W, 4) uint8 view)
    → its (H, W, 4) uint8 pixels on the host; raises on any other."""
    import torch

    from mt_renderer_tpu_torch.app.manager import _to_rgba

    if not ((color.dtype == torch.int32 and tuple(color.shape) == (h, w))
            or (color.dtype == torch.uint8
                and tuple(color.shape) == (h, w, 4))):
        raise AssertionError(f"{what} frame malformed: {color.dtype} "
                             f"{tuple(color.shape)}")
    return _to_rgba(color)


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
                **raster_bound(args[:4], got, kw.get("zlow"), surviving))


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
    return dict(kind=name, count=count, card=smi.strip().splitlines()[0])


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
    dv.bc7_trilinear.launches = 0


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
    lit as asked) → the K1 launch count of this run and coverage."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import engine as en
    from mt_renderer_tpu_torch.render import raster as rs

    what = "mip+light main path" if mipmap or lighting else "main path"
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
    per_frame = []
    reset_launches()
    for t in range(frames):
        before = rs.raster_fwd.launches
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        vp = demo.view_proj()
        bones = demo.bone_mats(0.3 * t)
        color, depth = eng.render(vp, bones)
        per_frame.append(rs.raster_fwd.launches - before)
        if t == 0:
            first = (color, depth, vp, bones, eng.maxc, eng.tap_tiles)
    launches = rs.raster_fwd.launches
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
    return dict(launches=launches, coverage=coverage)


def k2_split_reading(glass: dict, n: int, band: int, what: str) -> dict:
    """K2 against its plain version as the split peel calls it on band
    ``band`` of ``n`` of the glass case (the whole frame for n = 1): the
    translucent set binned at the band's origin, no opaque cull, the
    band's opaque z from K1 as ``zhi``, L = LAYERS; its breakdown and
    both times (logged as ``raster_ml_<what>_kernel_ms`` and
    ``_plain_ms``) → a record's readings. Raises if either binning
    overflows."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    maxc = glass["maxc"]
    (_, (cols_tr, bbox_tr)), oargs, (pw, pb), nov_op = band_args(
        glass["scene"], glass["vp"], glass["bones"], glass["width"],
        glass["height"], n, band, maxc, opacity_split=True)
    kw = dict(width=pw, height=pb, w_eps=dv.W_EPS)
    zo, io = rs.raster_fwd(*oargs, **kw)[:2]
    zhi = torch.where(io >= 0, zo, float("inf"))
    lists, glists, counts, n_over = rs.prebin(
        cols_tr, bbox_tr, *oargs[4], width=pw, height=pb, maxc=maxc)
    if int(n_over) or int(nov_op):
        raise AssertionError(f"{what}: a binning overflows maxc")
    args = (cols_tr, lists, glists, counts, oargs[4])
    mlkw = dict(kw, layers=LAYERS, opaque_cull=False, zhi=zhi)
    got = rs.raster_fwd_ml(*args, **mlkw)
    want = rs.raster_fwd_ml_reference(*args, **mlkw)
    torch.cuda.synchronize()
    err = compare_outputs(
        got, want, f"K2 vs plain, {what} {pw}x{pb} at {args[4]}, "
        f"translucent set, nocull + zhi, L={LAYERS}, maxc={lists.shape[1]}")
    kernel_ms = graph_ms(lambda: rs.raster_fwd_ml(*args, **mlkw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_ml_reference(*args, **mlkw),
                       warmup=1, reps=5)
    tag = "_".join(what.replace(",", " ").split())
    log(f"raster_ml_{tag}_kernel_ms {kernel_ms!r}")
    log(f"raster_ml_{tag}_plain_ms {plain_ms!r}")
    bnd = k2_breakdown(args, mlkw, got, f"{what}, tap, nocull + zhi")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, **bnd)


def phase_ml_kernel(glass: dict, opaque: dict) -> dict:
    """K2 against its plain version: on the glass headline as the split
    peel calls it (translucent set, no opaque cull, K1's opaque z-buffer
    as ``zhi``), and with the opaque cull on the opaque headline."""
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = glass["width"], glass["height"]
    pw, ph = dv._padded(w, h)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS)
    reading = k2_split_reading(glass, 1, 0, "glass headline")
    err = reading["max_abs_err"]

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
    return dict(reading, max_abs_err=err)


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
    run."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import engine as en
    from mt_renderer_tpu_torch.render import raster as rs

    what = ("peeled mip+light glass main path" if mipmap or lighting
            else "glass main path")
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
    per_frame = []
    reset_launches()
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
    k1, k2 = rs.raster_fwd.launches, rs.raster_fwd_ml.launches
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
    # the engine's format: the peeled mip frame is the uint8 view
    rgba0 = frame_rgba(color0, h, w, f"{what} frame 0")
    if (color0.dtype == torch.uint8) != (not eng.packed) \
            or tuple(depth0.shape) != (h, w) \
            or not bool(torch.isfinite(depth0).all()):
        raise AssertionError(f"{what} frame 0 malformed: {color0.dtype} "
                             f"{tuple(color0.shape)}, packed {eng.packed}")
    coverage = float((depth0 < 1.0).float().mean())
    plain, _, _ = dv._render_frame_peeled_core(
        glass["scene"], vp0, bones0, width=w, height=h, layers=LAYERS,
        clear_color=(255, 255, 255, 255), maxc=maxc0, peel_mode="split",
        tap_tiles=taps0, mipmap=mipmap, lighting=lighting,
        raster=rs.raster_fwd_reference,
        raster_ml=rs.raster_fwd_ml_reference)
    share, n_diff = golden_share(rgba0, dv.unpack_rgba(plain))
    log(f"{what} frame 0 vs plain rasters: {share:.6f} of pixels off by "
        f"> 1, {n_diff} pixels differ; coverage {coverage:.4f}")
    if share > GOLDEN_SHARE or not 0.0 < coverage <= 1.0:
        raise AssertionError(f"{what} frame 0 is wrong")
    return dict(k1=k1, k2=k2)


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
    of the loop and its record."""
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

    k1 = k1_mtap_at(case.scene, vp0, dev_pal, w, h, maxc, "world")

    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"{rs.OVERFLOW_EVENTS} overflow events before "
                             "the world main path")
    dur = max(case.world.timeline.duration, 1)
    per_frame = []
    reset_launches()
    for t in range(FRAMES):
        before = rs.raster_fwd.launches
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        color, depth = dv.render_frame(
            case.scene, case.view_proj(),
            case.bone_mats_device((2.0 * t) % dur), **fkw)
        per_frame.append(rs.raster_fwd.launches - before)
    launches = rs.raster_fwd.launches
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
    return dict(launches=launches, **k1)


def k1_reading(args, kw, what: str) -> dict:
    """K1 against its plain version on prebinned ``args`` (cols, lists,
    glists, counts, origin) with ``kw``, its breakdown and both times
    (logged as ``raster_<what>_kernel_ms`` and ``_plain_ms``) → a
    record's readings."""
    import torch

    from mt_renderer_tpu_torch.render import raster as rs

    got = rs.raster_fwd(*args, **kw)
    want = rs.raster_fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    err = compare_outputs(got, want, f"K1 vs plain, {what}, origin "
                          f"{args[4]}, {kw['width']}x{kw['height']}, "
                          f"{args[0].shape[1]} tris, maxc={args[1].shape[1]}")
    bnd = k1_breakdown(args, kw, got, what)
    del got, want
    kernel_ms = graph_ms(lambda: rs.raster_fwd(*args, **kw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_reference(*args, **kw),
                       warmup=1, reps=5)
    tag = "_".join(what.replace("+", " ").replace(",", " ").split())
    log(f"raster_{tag}_kernel_ms {kernel_ms!r}")
    log(f"raster_{tag}_plain_ms {plain_ms!r}")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, **bnd)


def band_args(scene, vp, bones, w: int, h: int, n: int, band: int,
              maxc: int, lighting: bool = False, opacity_split=False):
    """The full frame's setup binned over band ``band`` of ``n`` (the
    opaque set's under ``opacity_split``) → (the setup, (cols, lists,
    glists, counts, origin) of that band, its padded grid (pw, pb), the
    binning's count of tiles over ``maxc``)."""
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    band_h, pb = dv.band_rows(h, n)
    pw, _ = dv._padded(w, h)
    setup = dv.setup_packed_cols(scene, dv.vertex_stage(scene, vp, bones),
                                 w, h, opacity_split=opacity_split,
                                 bone_mats=bones, lighting=lighting)
    cols, bbox = setup[0] if opacity_split else setup
    y0 = band * band_h
    lists, glists, counts, n_over = rs.prebin(cols, bbox, 0, y0, width=pw,
                                              height=pb, maxc=maxc)
    return setup, (cols, lists, glists, counts, (0, y0)), (pw, pb), n_over


def k1_mtap_at(scene, vp, pal, w: int, h: int, maxc: int,
               what: str) -> dict:
    """K1 (mtap, unlit) against its plain version on the inputs of one
    mipmapped frame (``what``'s frame 0), its breakdown and both times →
    its record's readings."""
    from mt_renderer_tpu_torch.render import device as dv

    _, args, (pw, ph), _ = band_args(scene, vp, pal, w, h, 1, 0, maxc)
    return k1_reading(args, dict(width=pw, height=ph, w_eps=dv.W_EPS,
                                 mode="mtap"), f"{what} mtap")


def decoded_chains(batch, mode: str = "bc1") -> list:
    """Each texture's box-filter chain with every level encoded and
    decoded: BC1 through ``native``, or BC7 mode 6 (the bc7 pool's
    synthetic content) decoded through ``native``; the content a bc1 or
    bc7 pool of ``batch`` holds."""
    from mt_renderer_tpu_torch import native
    from mt_renderer_tpu_torch.render import bcn
    from mt_renderer_tpu_torch.render import device as dv

    def level(img):
        h, w = img.shape[:2]
        if mode == "bc1":
            return native.decode_bc1(native.encode_bc1(img).tobytes(), w, h)
        return native.decode_bc7(bcn.encode_bc7_mode6_numpy(img).tobytes(),
                                 w, h)

    return [[level(img) for img in dv.mip_chain(t)] for t in batch.textures]


def all_mode_chains(batch, seed: int = 0) -> tuple:
    """Per texture, its box-filter chain's level sizes filled with seeded
    random BC7 blocks of all eight modes (random bytes under a valid mode
    prefix) → (``bc7_chains`` for ``upload``, their decoded chains)."""
    from mt_renderer_tpu_torch import native
    from mt_renderer_tpu_torch.render import device as dv

    rng = np.random.default_rng(seed)
    chains, dec = [], []
    for t in batch.textures:
        ch, dch = [], []
        for img in dv.mip_chain(t):
            h, w = img.shape[:2]
            n = ((h + 3) // 4) * ((w + 3) // 4)
            blk = rng.integers(0, 256, (n, 16), dtype=np.uint8)
            m = rng.integers(0, 8, n)
            blk[:, 0] = ((1 << m) | ((blk[:, 0].astype(np.int64) << (m + 1))
                                     & 0xFF)).astype(np.uint8)
            ch.append((blk, h, w))
            dch.append(native.decode_bc7(blk.tobytes(), w, h))
        chains.append(ch)
        dec.append(dch)
    return chains, dec


def log_pool_stats(what: str, scene) -> dict:
    from mt_renderer_tpu_torch.render import device as dv

    st = dv.pool_stats(scene)
    log(f"pool_stats, {what}: {json.dumps(st)}")
    return st


def phase_bcn_world(device, mode: str, earlier: dict | None = None) -> dict:
    """(a) and (e): the full world (the bench's ``pallas world`` row)
    with the ``mode`` ("bc1" or "bc7", mode-6 content) texel pool,
    ``entry.world_case(pool_mode=mode)``: frame 0 equal, bit for bit, to
    the frame of a tri pool of its decoded chains (``upload(
    mip_chains=)``); the pool_stats of the pool, that tri pool, (bc1) a
    quad scene and the ``earlier`` stats again, by name; K1 (mtap)
    against its plain version on frame 0's inputs; then FRAMES frames of
    ``FrameEngine(mipmap=True)`` with each palette computed on the card,
    launches counted from 0: K1 in every frame, no overflow. → K1's
    launch count, its record and the stats."""
    import torch

    from mt_renderer_tpu_torch import native
    from mt_renderer_tpu_torch.entry import world_case
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import engine as en
    from mt_renderer_tpu_torch.render import raster as rs

    log(f"native library for the {mode.upper()} codec: "
        f"available={native.available()}")
    t0 = time.perf_counter()
    case = world_case(device, pool_mode=mode, **WORLD)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w, h, cam = case.width, case.height, case.camera
    base_yaw = cam.yaw
    vp0, host_pal = case.view_proj(), case.bone_mats(0.0)
    maxc = dv.auto_maxc(case.batch, vp0, host_pal, width=w, height=h)
    taps = dv.auto_tap_tiles(case.batch, vp0, host_pal, width=w, height=h)
    t0 = time.perf_counter()
    ref = dv.upload(case.batch, "tri", device=device,
                    mip_chains=decoded_chains(case.batch, mode))
    torch.cuda.synchronize()
    log(f"{mode} world: {case.world.info}, {w}x{h}, maxc={maxc}, "
        f"tap_tiles={taps}, bc7_modes={case.scene.bc7_modes}, set-up "
        f"(build, encode, upload) {setup_s:.1f} s; tri pool of the decoded "
        f"chains {time.perf_counter() - t0:.1f} s")
    stats = {mode: log_pool_stats(f"{mode} world", case.scene),
             "tri": log_pool_stats("tri world (decoded chains)", ref)}
    if mode == "bc1":
        quad = dv.upload(case.batch, "quad", device=device)
        stats["quad"] = log_pool_stats("quad world", quad)
        del quad
    for name, st in (earlier or {}).items():
        log(f"pool_stats, {name} world (an earlier phase): {json.dumps(st)}")
    if stats[mode]["bytes"] != stats[mode]["rows"] * (
            64 if mode == "bc1" else 128) or stats["tri"]["rows"] < \
            stats[mode]["rows"]:
        raise AssertionError(f"the {mode} world's pool_stats are wrong")

    fkw = dict(width=w, height=h, mipmap=True, packed=True, maxc=maxc,
               tap_tiles=taps)
    pal = case.bone_mats_device(0.0)
    a, ad = dv.render_frame(case.scene, vp0, pal, **fkw)
    b, bd = dv.render_frame(ref, vp0, pal, **fkw)
    rs.flush_overflow_checks()
    n_px = int((a != b).sum())
    coverage = float((ad < 1.0).float().mean())
    log(f"{mode} world frame 0 vs the tri pool of its decoded chains: "
        f"{n_px} pixels differ, depth equal {bool(torch.equal(ad, bd))}; "
        f"coverage {coverage:.4f}")
    if n_px or not torch.equal(ad, bd) or not 0.0 < coverage <= 1.0 \
            or rs.OVERFLOW_EVENTS:
        raise AssertionError(f"the {mode} world frame differs from its "
                             "decoded chains' frame")
    del a, b, ref

    pw, ph = dv._padded(w, h)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode="mtap")
    cols, bbox = dv.setup_packed_cols(
        case.scene, dv.vertex_stage(case.scene, vp0, pal), w, h)
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=maxc)
    args = (cols, lists, glists, counts, (0, 0))
    got = rs.raster_fwd(*args, **kw)
    want = rs.raster_fwd_reference(*args, **kw)
    torch.cuda.synchronize()
    err = compare_outputs(got, want, f"K1 mtap vs plain, {mode} world frame "
                          f"0, {cols.shape[1]} tris, maxc={lists.shape[1]}")
    bnd = k1_breakdown(args, kw, got, f"{mode} world frame 0, mtap")
    del got, want
    kernel_ms = graph_ms(lambda: rs.raster_fwd(*args, **kw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_reference(*args, **kw),
                       warmup=1, reps=5)
    log(f"raster_{mode}_world_mtap_kernel_ms {kernel_ms!r}")
    del args, cols, lists, glists, counts

    eng = en.FrameEngine(case.scene, case.batch, width=w, height=h,
                         mipmap=True)
    rs.flush_overflow_checks()
    dur = max(case.world.timeline.duration, 1)
    per_frame = []
    reset_launches()
    for t in range(FRAMES):
        before = rs.raster_fwd.launches
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        color, depth = eng.render(case.view_proj(),
                                  case.bone_mats_device((2.0 * t) % dur))
        per_frame.append(rs.raster_fwd.launches - before)
    launches = rs.raster_fwd.launches
    cam.yaw = base_yaw
    eng.check()
    rs.flush_overflow_checks()
    log(f"{mode} world main path (FrameEngine): {FRAMES} frames, K1 "
        f"launches {launches}, overflow events {rs.OVERFLOW_EVENTS}, caps "
        f"maxc={eng.maxc} tap_tiles={eng.tap_tiles}, recoveries "
        f"{eng.recoveries}")
    if min(per_frame) < 1 or rs.OVERFLOW_EVENTS:
        raise AssertionError(f"a {mode} world frame launched no K1, or "
                             "overflowed")
    if (tuple(color.shape) != (h, w) or color.dtype != torch.int32
            or not bool((depth < 1.0).any())):
        raise AssertionError(f"the last {mode} world frame is malformed")
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, stats=stats, **bnd)


def bc7_kernel_reading(scene, vp, pal, fkw) -> dict:
    """The bc7 trilinear kernel at the ``world_bc7.orbit`` cell's shapes:
    the taps of frame 0's compacted shade over every live row (the cell's
    engine holds every tile), caught at the op ``device.BC7_OP`` as the
    shade hands them over. The kernel against its plain twin on them (bit
    for bit, NaN for NaN), its time (CUDA-graph replays) and the twin's
    (events), and its bound: each tap's 24 B of inputs and 16 B of
    output, each distinct 128 B pool row (and 64 B hint row) read once;
    beside it the bound at ``BC7_TAP_BYTES`` a tap, as if no two taps
    shared a row."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = fkw["width"], fkw["height"]
    pw, ph = dv._padded(w, h)
    cols, bbox = dv.setup_packed_cols(
        scene, dv.vertex_stage(scene, dv._f32(vp, scene.device), pal), w, h)
    pre = rs.prebin(cols, bbox, 0, 0, width=pw, height=ph, maxc=fkw["maxc"])
    _, ib, mattrs = rs.raster_fwd(cols, *pre[:3], (0, 0), width=pw,
                                  height=ph, w_eps=dv.W_EPS, mode="mtap")
    caught = []
    real = dv.BC7_OP

    def catch(*args):
        caught.append(args)
        return real(*args)

    dv.BC7_OP = catch
    try:
        dv.shade_mip_tap_flat_channels(scene, mattrs, ib, tap_tiles=None)
    finally:
        dv.BC7_OP = real
    args = caught[0]
    pool, aux, taps, num_mips, modes = (args[0], args[1], args[2:8],
                                        args[8], args[9])
    got = dv._bc7_trilinear_cuda(*args)
    want = dv.bc7_trilinear_reference(*args)
    torch.cuda.synchronize()
    same = (got == want) | (got.isnan() & want.isnan())
    n_off = int((~same).sum())
    n_nan = int(got.isnan().sum())
    err = float(torch.where(same, 0.0, (got - want).abs()).max())
    ms = graph_ms(lambda: dv._bc7_trilinear_cuda(*args))
    plain_ms = cuda_ms(lambda: dv.bc7_trilinear_reference(*args),
                       warmup=1, reps=3)
    _, m0, _, _, _ = dv._levels(taps[1], taps[2], taps[3], num_mips)
    off_a, hm0, wm0 = dv._mip_arith_bc1(taps[0], taps[1], taps[2], m0,
                                        num_mips)
    x0c, y0c, _, _, _, _ = dv._footprint(wm0, hm0, taps[4], taps[5])
    idx = off_a + (y0c >> 2) * ((wm0 + 3) >> 2) + (x0c >> 2)
    rows = int(torch.unique(idx.clamp(0, pool.shape[0] - 1)).numel())
    n = taps[0].numel()
    n_bytes = n * (24 + 16) + rows * (128 + (64 if aux is not None else 0))
    bnd = bound(n_bytes, 0)
    per_tap_ms = n * BC7_TAP_BYTES / HBM_BYTES_PER_S * 1e3
    log(f"bc7 trilinear kernel vs plain, world at {w}x{h}, all modes "
        f"{modes}: {n} taps ({n // dv.SEG_PX} rows of {dv.SEG_PX} px), "
        f"{rows} distinct pool rows, {n_off} values differ, {n_nan} NaN, "
        f"max_abs_err {err!r}; bc7_trilinear_kernel_ms {ms!r}, plain "
        f"{plain_ms!r} ms; bound {bnd['bound_ms']!r} ms ({n_bytes} B), "
        f"{per_tap_ms!r} ms at {BC7_TAP_BYTES} B a tap")
    if n_off:
        raise AssertionError("the bc7 trilinear kernel differs from its "
                             "plain twin")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, taps=n,
                rows=rows, per_tap_bound_ms=per_tap_ms, **bnd)


def phase_bc7_multimode(device) -> dict:
    """(f) The world's textures as seeded random BC7 blocks of all eight
    modes through ``upload(pool_mode="bc7", bc7_chains=)``: every mode
    present and the hint pool built; frame 0 (K1 launches counted from 0)
    equal, bit for bit, to the frame of a tri pool of the decoded chains;
    its pool_stats; the bc7 trilinear kernel's record
    (``bc7_kernel_reading``)."""
    import torch

    from mt_renderer_tpu_torch.entry import world_case
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    case = world_case(device, pool_mode="quad", **WORLD)
    chains, dec = all_mode_chains(case.batch)
    scene = dv.upload(case.batch, "bc7", device=device, bc7_chains=chains)
    ref = dv.upload(case.batch, "tri", device=device, mip_chains=dec)
    torch.cuda.synchronize()
    st = log_pool_stats("bc7 world, all eight modes", scene)
    log(f"bc7 all-mode world: bc7_modes {scene.bc7_modes}, hint pool "
        f"{tuple(scene.aux_pool.shape)}, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    blocks = st["rows"]
    if scene.bc7_modes != tuple(range(8)) or st["bytes"] != \
            blocks * 128 + (blocks + 1) // 2 * 128:
        raise AssertionError("the all-mode bc7 pool lacks a mode or its "
                             "hint pool")
    w, h = case.width, case.height
    vp0 = case.view_proj()
    host_pal = case.bone_mats(0.0)
    fkw = dict(width=w, height=h, mipmap=True, packed=True,
               maxc=dv.auto_maxc(case.batch, vp0, host_pal, width=w,
                                 height=h),
               tap_tiles=dv.auto_tap_tiles(case.batch, vp0, host_pal,
                                           width=w, height=h))
    pal = case.bone_mats_device(0.0)
    reset_launches()
    a, ad = dv.render_frame(scene, vp0, pal, **fkw)
    launches = rs.raster_fwd.launches
    bc7_launches = dv.bc7_trilinear.launches
    b, bd = dv.render_frame(ref, vp0, pal, **fkw)
    rs.flush_overflow_checks()
    n_px = int((a != b).sum())
    log(f"bc7 all-mode world frame 0 vs the tri pool of its decoded "
        f"chains: {n_px} pixels differ, depth equal "
        f"{bool(torch.equal(ad, bd))}, K1 launches {launches}, bc7 "
        f"trilinear launches {bc7_launches}")
    if n_px or not torch.equal(ad, bd) or min(launches, bc7_launches) < 1 \
            or rs.OVERFLOW_EVENTS or not bool((ad < 1.0).any()):
        raise AssertionError("the all-mode bc7 world frame differs from its "
                             "decoded chains' frame")
    del a, b, ref
    kernel = bc7_kernel_reading(scene, vp0, pal, fkw)
    return dict(kernel, launches=bc7_launches)


def with_opacity_flags(ref, scene, what: str):
    """``ref`` (a pool of ``scene``'s decoded chains) with ``scene``'s
    per-triangle texture-opacity flags (``cols_const`` row 9), logging
    how many differ. Upload flags a synthetic bc1 or bc7 pool's textures
    by their source alpha, as the reference does, and BC7 mode 6 may
    round an alpha of 255 to 254, which flags the decoded chains'
    texture translucent; the split peel partitions by the flag, so the
    frames are held with one set of flags: the comparison is of the
    texels."""
    import dataclasses

    import torch

    n = int((ref.cols_const[9] != scene.cols_const[9]).sum())
    log(f"{what}: {n} triangles' opacity flags differ between the pool and "
        f"its decoded chains'; the decoded chains' pool takes the pool's")
    return dataclasses.replace(ref, cols_const=torch.cat(
        [ref.cols_const[:9], scene.cols_const[9:]]))


def phase_bcn_peel(device, mode: str) -> dict:
    """(b) and (g): the glass headline with the ``mode`` ("bc1" or "bc7",
    mode-6 content) pool, peeled mip+light (split, L = LAYERS): equal,
    bit for bit, to the same frame from a tri pool of its decoded chains
    (with the pool's opacity flags: ``with_opacity_flags``), K2's
    launches in the ``mode`` frame counted from 0; K2 (mtap + lit)
    against its plain version as that frame calls it (the translucent
    set, no opaque cull, K1's opaque z as ``zhi``), timed, with its
    breakdown. → K2's record."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    glass = headline_case(device, **dict(GLASS, pool_mode=mode))
    batch, scene = glass["demo"].batch, glass["scene"]
    ref = with_opacity_flags(dv.upload(
        batch, "tri", device=device, mip_chains=decoded_chains(batch, mode)),
        scene, f"{mode} glass headline")
    log_pool_stats(f"{mode} glass headline", scene)
    w, h, vp, bones = glass["width"], glass["height"], glass["vp"], \
        glass["bones"]
    kw = dict(width=w, height=h, layers=LAYERS, maxc=glass["maxc"],
              lighting=True)
    caps = dv.measure_live_tap_tiles(scene, vp, bones, mode="split", **kw)
    fkw = dict(kw, peel_mode="split", packed=True, mipmap=True,
               tap_tiles=caps)
    reset_launches()
    a, ad = dv.render_frame_peeled(scene, vp, bones, **fkw)
    launches = rs.raster_fwd_ml.launches
    b, bd = dv.render_frame_peeled(ref, vp, bones, **fkw)
    rs.flush_overflow_checks()
    n_px = int((a != b).sum())
    log(f"{mode} glass headline, split peel L={LAYERS} mip+light, caps "
        f"{caps}: {n_px} pixels differ from the tri pool of its decoded "
        f"chains, depth equal {bool(torch.equal(ad, bd))}; K2 launches "
        f"{launches}")
    if n_px or not torch.equal(ad, bd) or rs.OVERFLOW_EVENTS \
            or launches < 1:
        raise AssertionError(f"the {mode} peeled frame differs from its "
                             "decoded chains' frame")
    del ref, a, b

    pw, ph = dv._padded(w, h)
    mkw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode="mtap",
               light=dv._light_unit())
    (cols_op, bbox_op), (cols_tr, bbox_tr) = dv.setup_packed_cols(
        scene, dv.vertex_stage(scene, vp, bones), w, h, opacity_split=True,
        bone_mats=bones, lighting=True)
    pre = rs.prebin(cols_op, bbox_op, 0, 0, width=pw, height=ph,
                    maxc=glass["maxc"])
    zo, io = rs.raster_fwd(cols_op, *pre[:3], (0, 0), **mkw)[:2]
    zhi = torch.where(io >= 0, zo, float("inf"))
    lists, glists, counts, _ = rs.prebin(cols_tr, bbox_tr, 0, 0, width=pw,
                                         height=ph, maxc=glass["maxc"])
    args = (cols_tr, lists, glists, counts, (0, 0))
    mlkw = dict(mkw, layers=LAYERS, opaque_cull=False, zhi=zhi)
    got = rs.raster_fwd_ml(*args, **mlkw)
    want = rs.raster_fwd_ml_reference(*args, **mlkw)
    torch.cuda.synchronize()
    err = compare_outputs(got, want, f"K2 mtap+lit vs plain, {mode} glass "
                          f"headline, translucent set, nocull + zhi, "
                          f"L={LAYERS}")
    bnd = k2_breakdown(args, mlkw, got, f"{mode} glass headline, mtap + lit, "
                       "nocull + zhi")
    del got, want
    kernel_ms = graph_ms(lambda: rs.raster_fwd_ml(*args, **mlkw))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_ml_reference(*args, **mlkw),
                       warmup=1, reps=3)
    log(f"raster_ml_{mode}_mtap_lit_kernel_ms {kernel_ms!r}")
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, **bnd)


def phase_bench_legs(device) -> dict:
    """(h) The reference bench's verify legs (``verify.bench_legs``:
    256x256, 9 instances at subdiv 2) on the card, each leg's readings
    printed → the legs."""
    from mt_renderer_tpu_torch import verify
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    reset_launches()
    r = verify.bench_legs(device, **verify.BENCH_LEGS)
    log(f"bench verify legs, {json.dumps(verify.BENCH_LEGS)} "
        f"({time.perf_counter() - t0:.1f} s; K1 launches "
        f"{rs.raster_fwd.launches}, K2 {rs.raster_fwd_ml.launches}):")
    for leg, v in r.items():
        if isinstance(v, dict):
            log(f"  {leg}: {json.dumps(v)}")
    if not r["passed"] or rs.OVERFLOW_EVENTS or rs.raster_fwd.launches < 1 \
            or rs.raster_fwd_ml.launches < 1:
        raise AssertionError("a bench verify leg failed")
    # (c2) the scan backend's legs, and the mip leg held against scan
    if not (r["scan"]["passed"] and r["peel_scan"]["passed"]
            and r["mipmap_packed"]["scan_passed"]):
        raise AssertionError("(c2) a scan verify leg is missing or failed")
    return r


def phase_narrow(case: dict) -> None:
    """(c) The narrow pool on the mip+light headline: its frame equals
    the quad pool's bit for bit; its tap frame raises ValueError."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    narrow = dv.upload(case["demo"].batch, "narrow",
                       device=case["scene"].device)
    log_pool_stats("narrow headline", narrow)
    fkw = dict(width=case["width"], height=case["height"], packed=True,
               mipmap=True, lighting=True, maxc=case["maxc"],
               tap_tiles=case["taps"])
    a, ad = dv.render_frame(narrow, case["vp"], case["bones"], **fkw)
    b, bd = dv.render_frame(case["scene"], case["vp"], case["bones"], **fkw)
    rs.flush_overflow_checks()
    n_px = int((a != b).sum())
    try:
        dv.render_frame(narrow, case["vp"], case["bones"],
                        width=case["width"], height=case["height"])
        refused = False
    except ValueError:
        refused = True
    log(f"narrow pool, mip+light headline: {n_px} pixels differ from the "
        f"quad pool's frame, depth equal {bool(torch.equal(ad, bd))}; the "
        f"tap frame refused: {refused}")
    if n_px or not torch.equal(ad, bd) or not refused or rs.OVERFLOW_EVENTS:
        raise AssertionError("the narrow pool's frame is wrong")


def phase_helpers(case: dict) -> None:
    """(d) ``count_covered_textured`` on the headline against the
    coverage and textured counts of K1's own outputs for that view
    (a pixel covered beyond z = 1 keeps its depth, so the frame's
    ``depth < 1`` is no count of it); ``upload("auto", mipmap=True)`` under
    ``pool_budget_default`` picks the tri pool."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = case["width"], case["height"]
    scene, vp, bones = case["scene"], case["vp"], case["bones"]
    reset_launches()
    cov, tex = dv.count_covered_textured(scene, vp, bones, width=w,
                                         height=h, maxc=case["maxc"])
    launched = rs.raster_fwd.launches
    pw, ph = dv._padded(w, h)
    cols, bbox = dv.setup_packed_cols(scene, dv.vertex_stage(scene, vp,
                                                             bones), w, h)
    pre = rs.prebin(cols, bbox, 0, 0, width=pw, height=ph, maxc=case["maxc"])
    _, ib, _, tapidx = rs.raster_fwd(cols, *pre[:3], (0, 0), width=pw,
                                     height=ph, w_eps=dv.W_EPS)
    ib = rs.unflatten_tiles(ib[:, 0], ph, pw)[:h, :w]
    ti = rs.unflatten_tiles(tapidx[:, 0], ph, pw)[:h, :w]
    want = (int((ib >= 0).sum()), int(((ib >= 0) & (ti >= 0)).sum()))
    log(f"count_covered_textured, headline: covered {int(cov)}, textured "
        f"{int(tex)} (K1 launches {launched}); from K1's outputs "
        f"{want[0]}, {want[1]}")
    if (int(cov), int(tex)) != want or launched < 1 or not want[0] > 0:
        raise AssertionError("count_covered_textured disagrees with K1")
    budget = dv.pool_budget_default(scene.device)
    auto = dv.upload(case["demo"].batch, "auto", device=scene.device,
                     mipmap=True)
    log(f"pool_budget_default on {torch.cuda.get_device_name(0)}: "
        f"{budget} bytes ({budget / 2**30:.2f} GiB); upload('auto', "
        f"mipmap=True) picked {auto.pool_mode}")
    if auto.pool_mode != "tri":
        raise AssertionError("auto did not pick the tri pool")


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

# --------------------------------------------------------------- viewers


def viewer_dir() -> Path:
    """Where the viewer phases write their fixtures and PNGs (``build/``
    is not committed)."""
    d = ROOT / "build" / "smoke_viewers"
    d.mkdir(parents=True, exist_ok=True)
    return d


class ViewerWatch:
    """Around one viewer run: each ``FrameEngine.render`` (its K1 and K2
    launches, a checksum of its frame, and frame 0's inputs and outputs),
    the first HUD composite (frame in, frame out, the band), each
    manager frame (the frame time before it, the camera after it) and
    every overflow count the engines' checks drain. Entering
    sets every launch count to 0."""

    def __enter__(self):
        from mt_renderer_tpu_torch.app import hud, manager
        from mt_renderer_tpu_torch.render import engine
        from mt_renderer_tpu_torch.render import raster as rs

        self.frames, self.sums, self.overflow = [], [], []
        self.first = self.hud = None
        self.dt_before, self.cameras = [], []
        self._saved = [
            (engine.FrameEngine, "render", engine.FrameEngine.render),
            (rs, "flush_overflow_counts", rs.flush_overflow_counts),
            (hud.Hud, "apply", hud.Hud.apply),
            (manager.RendererAppManager, "run_frame",
             manager.RendererAppManager.run_frame)]
        render, counts, apply, run_frame = (s[2] for s in self._saved)
        watch = self
        import torch

        def w_render(eng, vp, bones=None):
            k1, k2 = rs.raster_fwd.launches, rs.raster_fwd_ml.launches
            color, depth = render(eng, vp, bones)
            watch.frames.append((rs.raster_fwd.launches - k1,
                                 rs.raster_fwd_ml.launches - k2))
            watch.sums.append(int(color.to(torch.int64).sum()))
            if watch.first is None:
                watch.first = dict(engine=eng, vp=np.asarray(vp),
                                   bones=bones, color=color, depth=depth,
                                   maxc=eng.maxc, tap_tiles=eng.tap_tiles)
            return color, depth

        def w_counts():
            c = counts()
            watch.overflow += [(w, n) for w, (n, _) in c.items() if n > 0]
            return c

        def w_apply(h, mgr, frame, extra=""):
            out = apply(h, mgr, frame, extra=extra)
            if watch.hud is None:
                watch.hud = dict(frame=frame, out=out, hud=h,
                                 band=h.overlay.canvas.packed().copy())
            return out

        def w_run_frame(mgr):
            watch.dt_before.append(mgr.frame_time)
            frame = run_frame(mgr)
            c = mgr.camera
            watch.cameras.append((c.yaw, c.pitch, c.position.copy()))
            return frame

        for (owner, name, _), fn in zip(self._saved, (w_render, w_counts,
                                                      w_apply, w_run_frame)):
            setattr(owner, name, fn)
        reset_launches()
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def check_viewer_run(watch: ViewerWatch, what: str, frames: int,
                     k2: bool = False) -> tuple:
    """Every frame launched K1 (and K2 where asked), no overflow was
    drained or reported → the run's K1 and K2 launch counts."""
    from mt_renderer_tpu_torch.render import raster as rs

    rs.flush_overflow_checks()
    k1n, k2n = rs.raster_fwd.launches, rs.raster_fwd_ml.launches
    log(f"viewer {what}: {len(watch.frames)} engine frames, K1 launches "
        f"{k1n}, K2 launches {k2n} (per frame {watch.frames}), overflow "
        f"{watch.overflow}, overflow events {rs.OVERFLOW_EVENTS}")
    if len(watch.frames) != frames:
        raise AssertionError(f"{what}: {len(watch.frames)} frames rendered, "
                             f"{frames} asked")
    if any(a < 1 or (k2 and b < 1) for a, b in watch.frames):
        raise AssertionError(f"a frame of {what} launched no K1"
                             + (" or no K2" if k2 else ""))
    if watch.overflow or rs.OVERFLOW_EVENTS:
        raise AssertionError(f"overflow on {what}")
    return k1n, k2n


def viewer_frame0_vs_plain(watch: ViewerWatch, what: str,
                           rows: slice = slice(None)) -> float:
    """The engine's frame 0 (``rows`` of the frame the viewer shows)
    under the golden rule against the same view through the plain
    rasters."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    f = watch.first
    eng = f["engine"]
    kw = dict(width=eng.width, height=eng.height,
              clear_color=(255, 255, 255, 255), maxc=f["maxc"],
              tap_tiles=f["tap_tiles"], mipmap=eng.mipmap,
              lighting=eng.lighting, raster=rs.raster_fwd_reference)
    if eng.peel:
        plain, _, _ = dv._render_frame_peeled_core(
            eng.scene, f["vp"], f["bones"], layers=eng.peel,
            peel_mode=eng.peel_mode, raster_ml=rs.raster_fwd_ml_reference,
            **kw)
    else:
        plain, _, _ = dv._render_frame_core(eng.scene, f["vp"], f["bones"],
                                            **kw)
    shown = (watch.hud["out"] if watch.hud is not None else f["color"])
    rgba = frame_rgba(shown, eng.height, eng.width, f"{what} frame 0")
    if not bool(torch.isfinite(f["depth"]).all()):
        raise AssertionError(f"{what} frame 0 malformed")
    coverage = float((f["depth"] < 1.0).float().mean())
    share, n_diff = golden_share(rgba[rows], dv.unpack_rgba(plain)[rows])
    log(f"viewer {what} frame 0 vs plain rasters (rows {rows.start or 0}"
        f"-{eng.height}): {share:.6f} of pixels off by > 1, {n_diff} "
        f"pixels differ; coverage {coverage:.4f}")
    if share > GOLDEN_SHARE or not 0.0 < coverage <= 1.0:
        raise AssertionError(f"{what} frame 0 is wrong")
    return coverage


def hud_band_check(watch: ViewerWatch, what: str) -> int:
    """The band of the first HUD frame equals, bit for bit, the CPU
    composite of the same band onto the same frame → the band's rows."""
    import torch

    from mt_renderer_tpu_torch.scene import gui

    h = watch.hud
    band = torch.from_numpy(h["band"].view(np.int32))
    want = gui._composite_packed(h["frame"].cpu(), band, y0=0)
    n = int((h["out"].cpu() != want).sum())
    log(f"viewer {what}: HUD band {tuple(band.shape)} composited on "
        f"{h['out'].device}, {n} pixels differ from the CPU composite")
    if n or h["out"].device != watch.first["color"].device:
        raise AssertionError(f"{what}: the card's HUD composite differs")
    return band.shape[0]


def png_size(data: bytes) -> tuple:
    """(width, height) of a PNG that ``utils.png`` wrote, after checking
    that its pixel stream inflates to that size."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, color, _, _, _ = hdr
    if len(zlib.decompress(idat)) != h * (1 + w * {2: 3, 6: 4}[color]):
        raise AssertionError("PNG pixel stream of the wrong size")
    return w, h


def phase_viewer_demo(device, card: str) -> dict:
    """(v1) ``modelviewer --demo 280 --hud --hud-gmd`` at 1920x1080, 20
    frames: K1 in every frame, no overflow, frame 0 below the band under
    the golden rule against the plain K1, the band bit-equal to the CPU
    composite; the HUD's host raster, the band composite's device time,
    ``encode_png``; K1 against its plain version on frame 0's inputs →
    K1's record on this path."""
    import torch

    from mt_renderer_tpu_torch import fixtures
    from mt_renderer_tpu_torch.app.manager import _to_rgba
    from mt_renderer_tpu_torch.cli import modelviewer
    from mt_renderer_tpu_torch.utils.png import encode_png

    out = viewer_dir()
    gmd = out / "fixture_messages.gmd"
    gmd.write_bytes(fixtures.build_gmd())
    w, h = VIEWER["width"], VIEWER["height"]
    rs_flush_before("the viewer")
    with ViewerWatch() as watch:
        mgr = modelviewer.main([
            "--demo", str(VIEWER_WORLD), "--width", str(w), "--height",
            str(h), "--hud", "--hud-gmd", str(gmd), "--frames", str(FRAMES),
            "--out", str(out / "v1_last.png"), "--device", str(device)])
    k1n, _ = check_viewer_run(watch, f"(v1) modelviewer --demo "
                              f"{VIEWER_WORLD} --hud", FRAMES)
    band_rows = hud_band_check(watch, "(v1)")
    viewer_frame0_vs_plain(watch, "(v1)", rows=slice(band_rows, None))

    hud = watch.hud["hud"]
    c = hud.overlay.canvas
    reps = 50
    t0 = time.perf_counter()
    for i in range(reps):                 # bench.py:555-567
        c.clear()
        c.fill_rect(0, 0, c.width, c.height, (0, 0, 0, 150))
        c.draw_text(4, 4, f"{59.9:6.1f} fps  frame {i:5d}  {w}x{h}",
                    (255, 255, 255, 255), scale=2)
        c.packed()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    frame = watch.hud["frame"]
    hud.overlay.apply(frame)              # the band on the card once
    comp_ms = cuda_ms(lambda: hud.overlay.apply(frame), reps=50)
    band_bytes = 4 * c.width * c.height
    comp_bound = 3 * band_bytes / HBM_BYTES_PER_S * 1e3
    log(f"hud_host_raster_ms {host_ms!r} (band {c.width}x{c.height}, "
        f"NumPy, {reps} reps; {card})")
    log(f"hud_composite_device_ms {comp_ms!r} (CUDA events, 50 reps, "
        f"torch ops on the {c.width}x{c.height} band of a {w}x{h} frame, "
        f"the frame's clone included; bytes bound of the band alone "
        f"{comp_bound!r} ms; {card})")
    rgba = _to_rgba(mgr._last)
    enc = {}
    for level in (6, 1):
        t0 = time.perf_counter()
        for _ in range(3):
            data = encode_png(rgba, level=level)
        enc[level] = (time.perf_counter() - t0) / 3 * 1e3
        if png_size(data) != (w, h):
            raise AssertionError("encode_png gave the wrong size")
    log(f"encode_png_ms {enc[6]!r} at level 6 (write_png), {enc[1]!r} at "
        f"level 1 (the frame server), {w}x{h} RGBA, host clock ({card})")
    if png_size((out / "v1_last.png").read_bytes()) != (w, h):
        raise AssertionError("(v1) wrote a PNG of the wrong size")
    f = watch.first
    k1 = k1_mtap_at(f["engine"].scene, f["vp"], f["bones"], w, h,
                    f["maxc"], "viewer")
    torch.cuda.synchronize()
    return dict(launches=k1n, **k1)


def rs_flush_before(what: str) -> None:
    from mt_renderer_tpu_torch.render import raster as rs

    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"{rs.OVERFLOW_EVENTS} overflow events before "
                             f"{what}")


def phase_viewer_world_hud(device) -> None:
    """(v2) the bench's ``world+hud`` composite (bench.py:430-447,
    :550-575): the bench's world, a joint cube at every character joint,
    mipmapped, and the HUD band composited on the card, 20 frames
    through ``RendererAppManager``."""
    from mt_renderer_tpu_torch.app.hud import Hud
    from mt_renderer_tpu_torch.app.manager import (RendererApp,
                                                   RendererAppManager)
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render.engine import FrameEngine
    from mt_renderer_tpu_torch.scene import world
    from mt_renderer_tpu_torch.scene.model import merge_batches
    from mt_renderer_tpu_torch.scene.overlay import DebugOverlay

    class WorldHudApp(RendererApp):
        def setup(self, mgr):
            ws = world.build_world(
                buildings=WORLD["buildings"],
                building_subdivs=WORLD["building_subdivs"])
            ov = DebugOverlay()
            jp = ws.skeleton.joint_world_positions()
            for cm in ws.char_mats:
                for p in jp:
                    ov.add_cube_at((cm @ np.array([*p, 1.0], np.float32))[:3],
                                   scale=0.06)
            batch = merge_batches(ws.batch, ov.batch())
            log(f"(v2) world {ws.info}, +{ov.num_instances} joint cubes, "
                f"{batch.num_triangles} tris")
            self.ws, self.anim = ws, ws.animator()
            self.dur = max(ws.timeline.duration, 1)
            self.scene = dv.upload(batch, "auto", mipmap=True, device=device)
            self.eng = FrameEngine(self.scene, batch, width=mgr.width,
                                   height=mgr.height, mipmap=True)
            self.hud = Hud(mgr.width)
            mgr.camera = world.world_camera(mgr.width, mgr.height,
                                            buildings=WORLD["buildings"])
            self.base_yaw = mgr.camera.yaw

        def render(self, mgr):
            t = mgr.frame_index
            mgr.camera.yaw = self.base_yaw + 8.0 * np.sin(0.25 * t)
            pal = self.ws.bone_palette(self.anim.bone_mats_device(
                np.float32((2.0 * t) % self.dur), self.scene.device))
            color, _ = self.eng.render(mgr.camera.view_proj(), pal)
            return self.hud.apply(mgr, color, extra="world+hud")

    w, h = VIEWER["width"], VIEWER["height"]
    rs_flush_before("(v2)")
    app = WorldHudApp()
    mgr = RendererAppManager(app, width=w, height=h)
    with ViewerWatch() as watch:
        last = mgr.run_headless(frames=FRAMES)
        app.eng.check()
    check_viewer_run(watch, "(v2) world+hud", FRAMES)
    band_rows = hud_band_check(watch, "(v2)")
    viewer_frame0_vs_plain(watch, "(v2)", rows=slice(band_rows, None))
    if last.shape != (h, w, 4):
        raise AssertionError(f"(v2) frame of shape {last.shape}")


def phase_viewer_fixture(device) -> None:
    """(v3) the fixture tree's skinned character in ``modelviewer`` at
    1920x1080 with ``--overlay --sdl --mipmap --lighting --peel 4``: K1
    and K2 in every frame, no overflow, frame 0 under the golden rule
    against the plain rasters."""
    from mt_renderer_tpu_torch import fixtures
    from mt_renderer_tpu_torch.cli import modelviewer

    root = viewer_dir() / "fixtures"
    fixtures.write_fixture_tree(root)
    w, h = VIEWER["width"], VIEWER["height"]
    frames = 3
    rs_flush_before("(v3)")
    with ViewerWatch() as watch:
        modelviewer.main([
            str(root), str(root / "chara/fixture_character_skinned.chr"),
            "--overlay", "--sdl", str(root / "motion/fixture_bones.sdl"),
            "--mipmap", "--lighting", "--peel", str(LAYERS), "--frames",
            str(frames), "--width", str(w), "--height", str(h), "--out",
            str(viewer_dir() / "v3_last.png"), "--device", str(device)])
    check_viewer_run(watch, "(v3) modelviewer fixture --overlay --sdl "
                     f"--mipmap --lighting --peel {LAYERS}", frames, k2=True)
    viewer_frame0_vs_plain(watch, "(v3)")


def phase_viewer_events(device) -> None:
    """(v4) ``modelviewer --demo --events`` with WASD and mouse at
    1920x1080: the camera after every frame equals, bit for bit, the
    trajectory computed on the host from the same events and frame
    times, and every frame whose camera moved differs from the one
    before it."""
    from mt_renderer_tpu_torch.app.camera import Camera
    from mt_renderer_tpu_torch.app.manager import (RendererApp,
                                                   RendererAppManager)
    from mt_renderer_tpu_torch.cli import modelviewer
    from mt_renderer_tpu_torch.scene import world

    events = [[["mouse", 40, -10]], [["key_down", "W"]], [],
              [["key_down", "D"], ["mouse", -20, 5]],
              [["key_up", "W"], ["key_up", "D"]], [["key_down", "S"]],
              [["key_up", "S"], ["key_down", "A"], ["mouse", 7, 3]]]
    path = viewer_dir() / "v4_events.json"
    path.write_text(json.dumps(events))
    w, h = VIEWER["width"], VIEWER["height"]
    rs_flush_before("(v4)")
    with ViewerWatch() as watch:
        modelviewer.main([
            "--demo", str(VIEWER_SMALL_WORLD), "--events", str(path),
            "--width", str(w), "--height", str(h), "--out",
            str(viewer_dir() / "v4_last.png"), "--device", str(device)])
    check_viewer_run(watch, f"(v4) modelviewer --demo {VIEWER_SMALL_WORLD} "
                     "--events", len(events))
    cam = world.world_camera(w, h, buildings=VIEWER_SMALL_WORLD)
    speed = float(np.linalg.norm(cam.position)) * 0.2
    host = RendererAppManager(RendererApp(), width=w, height=h,
                              camera=Camera(cam.position, cam.yaw, cam.pitch,
                                            cam.fov, cam.near, cam.far))
    for i, evs in enumerate(events):
        for ev in evs:
            host.dispatch_event(tuple(ev))
        host.camera.update(host.input, host.aspect)
        host.camera.fly(host.input, dt=max(watch.dt_before[i], 1 / 60),
                        speed=speed)
        host.input.next_frame()
        yaw, pitch, pos = watch.cameras[i]
        if (yaw, pitch) != (host.camera.yaw, host.camera.pitch) or \
                not np.array_equal(pos, host.camera.position):
            raise AssertionError(f"(v4) camera of frame {i} is off the "
                                 "host trajectory")
    moved = [i for i in range(1, len(events))
             if not (watch.cameras[i][0] == watch.cameras[i - 1][0]
                     and watch.cameras[i][1] == watch.cameras[i - 1][1]
                     and np.array_equal(watch.cameras[i][2],
                                        watch.cameras[i - 1][2]))]
    same = [i for i in moved if watch.sums[i] == watch.sums[i - 1]]
    log(f"(v4) camera trajectory equals the host's over {len(events)} "
        f"frames; the camera moved in frames {moved}, frame checksums "
        f"{watch.sums}")
    if len(moved) < 5 or same:
        raise AssertionError(f"(v4) frames {same} did not change")


def phase_viewer_serve(device) -> None:
    """(v5) ``modelviewer --demo --serve 0 --serve-frames 10`` with a
    client thread: GET /frame.png (a 1920x1080 PNG) and /stats, POST
    events that reach the input state."""
    import threading
    import urllib.error
    import urllib.request

    from mt_renderer_tpu_torch.app import serve
    from mt_renderer_tpu_torch.app.input_state import Key
    from mt_renderer_tpu_torch.cli import modelviewer

    w, h = VIEWER["width"], VIEWER["height"]
    got: dict = {}
    orig = serve.FrameStreamServer.serve

    def client(port: int) -> None:
        base = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                got["png"] = urllib.request.urlopen(f"{base}/frame.png",
                                                    timeout=60).read()
                break
            except urllib.error.HTTPError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        req = urllib.request.Request(
            f"{base}/event", method="POST",
            data=json.dumps([["key_down", "W"], ["mouse", 12, -3]]).encode())
        got["queued"] = json.loads(urllib.request.urlopen(
            req, timeout=60).read())["queued"]
        got["stats"] = json.loads(urllib.request.urlopen(
            f"{base}/stats", timeout=60).read())

    def serve_with_client(srv, **kw):
        t = threading.Thread(target=lambda: client_safe(srv.port),
                             daemon=True)
        got["thread"] = t
        t.start()
        return orig(srv, **kw)

    def client_safe(port):
        try:
            client(port)
        except Exception as e:    # reported by the main thread below
            got["error"] = repr(e)

    serve.FrameStreamServer.serve = serve_with_client
    rs_flush_before("(v5)")
    try:
        with ViewerWatch() as watch:
            mgr = modelviewer.main([
                "--demo", str(VIEWER_SMALL_WORLD), "--serve", "0",
                "--serve-frames", "10", "--width", str(w), "--height",
                str(h), "--device", str(device)])
    finally:
        serve.FrameStreamServer.serve = orig
    got["thread"].join(timeout=60)
    check_viewer_run(watch, f"(v5) modelviewer --demo {VIEWER_SMALL_WORLD} "
                     "--serve", 10)
    if got["thread"].is_alive() or "error" in got:
        raise AssertionError(f"(v5) client failed: {got.get('error')}")
    size = png_size(got["png"])
    log(f"(v5) served {mgr.frame_index} frames; /frame.png {len(got['png'])}"
        f" B decodes to {size}; /event queued {got['queued']}; /stats "
        f"{got['stats']}; W held at the end: {mgr.input.has_key(Key.W)}")
    if (size != (w, h) or got["queued"] != 2 or got["stats"]["width"] != w
            or not mgr.input.has_key(Key.W) or mgr.frame_index != 10):
        raise AssertionError("(v5) the frame server misbehaved")


def phase_viewer_texture(device, card: str) -> None:
    """(v6) ``textureviewer`` at 1920x1080 on a 2048x2048 RGBA ``.tex``
    built by the port, raw and YCbCr: each PNG equal, byte for byte, to
    the same run on the CPU; the view's device time."""
    import torch

    from mt_renderer_tpu_torch.cli import textureviewer
    from mt_renderer_tpu_torch.formats import tex
    from mt_renderer_tpu_torch.render.texture_view import view_texture

    size = 2048
    img = np.random.default_rng(5).integers(0, 256, (size, size, 4),
                                            dtype=np.uint8)
    path = viewer_dir() / "v6_2048.tex"
    path.write_bytes(tex.write_texture(size, size,
                                       int(tex.TextureFormat.RGBA8),
                                       [img.tobytes()]))
    w, h = VIEWER["width"], VIEWER["height"]
    for raw in (True, False):
        pngs = {}
        for dev in (str(device), "cpu"):
            out = viewer_dir() / (f"v6_{'raw' if raw else 'ycbcr'}_"
                                  f"{dev.split(':')[0]}.png")
            textureviewer.main([str(path), "--width", str(w), "--height",
                                str(h), "--out", str(out), "--device", dev]
                               + (["--raw"] if raw else []))
            pngs[dev] = out.read_bytes()
        same = pngs[str(device)] == pngs["cpu"]
        log(f"(v6) textureviewer {'--raw' if raw else 'YCbCr'} {size}x{size}"
            f" -> {w}x{h}: card PNG equals the CPU's: {same}")
        if not same or png_size(pngs["cpu"]) != (w, h):
            raise AssertionError("(v6) the card's texture view differs")
    t = torch.from_numpy(img).to(device)
    for ycbcr in (False, True):
        ms = cuda_ms(lambda: view_texture(t, width=w, height=h,
                                          ycbcr=ycbcr), reps=20)
        log(f"view_texture_device_ms {ms!r} ({'YCbCr' if ycbcr else 'raw'},"
            f" {size}x{size} -> {w}x{h}, CUDA events, 20 reps; {card})")


def phase_viewer_scene(device) -> None:
    """(v7) ``sceneviewer`` on the fixture archive at 1920x1080 with the
    joint overlay: K1 launched, no overflow, the frame under the golden
    rule against the plain K1, a 1920x1080 PNG."""
    from mt_renderer_tpu_torch.cli import sceneviewer

    root = viewer_dir() / "fixtures"
    w, h = VIEWER["width"], VIEWER["height"]
    out = viewer_dir() / "v7_scene.png"
    rs_flush_before("(v7)")
    with ViewerWatch() as watch:
        sceneviewer.main([str(root), "fixture_scene", "--overlay",
                          "--width", str(w), "--height", str(h), "--out",
                          str(out), "--device", str(device)])
    check_viewer_run(watch, "(v7) sceneviewer fixture_scene --overlay", 1)
    viewer_frame0_vs_plain(watch, "(v7)")
    if png_size(out.read_bytes()) != (w, h):
        raise AssertionError("(v7) wrote a PNG of the wrong size")


def phase_viewers(device, card: str) -> dict:
    """(v1)-(v7) → K1's record on the viewer path (v1)."""
    t0 = time.perf_counter()
    k1 = phase_viewer_demo(device, card)
    phase_viewer_world_hud(device)
    phase_viewer_fixture(device)
    phase_viewer_events(device)
    phase_viewer_serve(device)
    phase_viewer_texture(device, card)
    phase_viewer_scene(device)
    log(f"viewer phases (v1)-(v7) in {time.perf_counter() - t0:.1f} s")
    return k1


# ------------------------------------------------- serving, profiling, CLIs


def serve_requests(art, case: dict, n: int) -> tuple:
    """``n`` requests to a ``serving.RenderArtifact`` with the camera yaw
    and the bones varying as in ``phase_main``, each between two CUDA
    events → (the requests' (view_proj, bones, color, depth), their ms)."""
    import torch

    demo = case["demo"]
    cam = demo.camera
    base_yaw = cam.yaw
    out, ms = [], []
    for t in range(n):
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        vp, bones = demo.view_proj(), demo.bone_mats(0.3 * t)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        color, depth = art(case["scene"], vp, bones)
        ev[1].record()
        out.append((vp, bones, color, depth))
        ms.append(ev)
    cam.yaw = base_yaw
    torch.cuda.synchronize()
    return out, [a.elapsed_time(b) for a, b in ms]


def phase_served(case: dict, what: str, requests: int, card: str,
                 mipmap: bool = False) -> dict:
    """(s1), (s2): ``serving.export_render`` of the case's scene on the
    card, ``load_render``, then ``requests`` requests with their K1
    launches counted from 0 and the overflow queue drained (it must read
    0); each served (color, depth) equal, bit for bit, to
    ``render_frame`` on the same inputs, whose request ms stand beside
    the served ones (CUDA events, median). → K1's launches."""
    import torch

    from mt_renderer_tpu_torch import serving
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = case["width"], case["height"]
    rs_flush_before(what)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = serving.export_render(case["scene"], width=w, height=h,
                                 mipmap=mipmap, platforms=["cuda"])
    t1 = time.perf_counter()
    art = serving.load_render(blob)
    t2 = time.perf_counter()
    log(f"{what}: export {t1 - t0!r} s, artifact {len(blob)} bytes, load "
        f"{t2 - t1!r} s")
    rs.flush_overflow_counts()
    reset_launches()
    served, served_ms = serve_requests(art, case, requests)
    launches = rs.raster_fwd.launches
    over = rs.flush_overflow_counts()
    log(f"{what}: {requests} requests, K1 launches {launches}, overflow "
        f"{over}")
    if launches != requests or rs.raster_fwd_ml.launches:
        raise AssertionError(f"{what}: {launches} K1 launches in "
                             f"{requests} requests")
    if any(n for n, _ in over.values()) or len(over) != 2:
        raise AssertionError(f"{what}: overflow {over}")
    eager_ms, n_bad = [], []
    for vp, bones, color, depth in served:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        want, wdepth = dv.render_frame(case["scene"], vp, bones, width=w,
                                       height=h, mipmap=mipmap)
        ev[1].record()
        ev[1].synchronize()
        eager_ms.append(ev[0].elapsed_time(ev[1]))
        if (tuple(color.shape) != (h, w, 4) or color.dtype != torch.uint8
                or not bool(torch.isfinite(depth).all())):
            raise AssertionError(f"{what}: a malformed frame "
                                 f"{color.dtype} {tuple(color.shape)}")
        n_bad.append(int((color != want).any(-1).sum())
                     + int((depth != wdepth).sum()))
    rs.flush_overflow_checks()
    coverage = float((served[0][3] < 1.0).float().mean())
    log(f"{what}: pixels off render_frame per request {n_bad}; coverage "
        f"{coverage:.4f}")
    if any(n_bad) or not 0.0 < coverage < 1.0:
        raise AssertionError(f"{what}: the served frame is not "
                             "render_frame's")
    log(f"{what}: served request ms median {float(np.median(served_ms))!r}"
        f", render_frame ms median {float(np.median(eager_ms))!r} (CUDA "
        f"events, {requests} requests each; {card})")
    return dict(launches=launches, vp=served[0][0], bones=served[0][1])


def phase_profile(case: dict, k1_ms: float, card: str) -> None:
    """(s3) One headline ``render_frame`` under ``utils.profiling.trace``:
    its Chrome trace must hold each ``frame.*`` span once as a
    ``user_annotation``, K1's ``__global__`` once as a CUDA kernel event
    with a duration (beside K1's graph-replay ms), and the runtime call
    that launched it (matched by correlation id) inside ``frame.raster``'s
    host range: the spans and the device trace share one clock."""
    import tempfile

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs
    from mt_renderer_tpu_torch.utils import profiling

    w, h, scene = case["width"], case["height"], case["scene"]
    vp, bones = case["vp"], case["bones"]
    spans = ("frame.vertex", "frame.setup", "frame.prebin", "frame.raster",
             "frame.shade", "frame.unflatten")

    def frame():
        return dv.render_frame(scene, vp, bones, width=w, height=h,
                               maxc=case["maxc"], tap_tiles=case["taps"])

    frame()                                           # warm-up
    rs.flush_overflow_checks()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as log_dir:
            frame()
        totals = profiling.span_totals()
        path = Path(log_dir) / profiling.TRACE_FILE
        events = json.loads(path.read_text())["traceEvents"]
        size = path.stat().st_size
    rs.flush_overflow_checks()
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "raster_fwd" in e.get("name", "")
               and "raster_fwd_ml" not in e["name"]]
    found = {s: [e for e in events if e.get("name") == s
                 and e.get("cat") == "user_annotation"] for s in spans}
    ids = {e.get("args", {}).get("correlation") for e in kernels}
    launch = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver")
              and e.get("args", {}).get("correlation") in ids]
    log(f"(s3) trace: {len(events)} events, {size} bytes; K1 kernel events "
        f"{len(kernels)}: " + "; ".join(
            f"{e['name']!r} {e.get('dur', 0) / 1e3!r} ms" for e in kernels)
        + f"; K1 graph replay {k1_ms!r} ms ({card})")
    log("(s3) spans (host ms): " + ", ".join(
        f"{s} {totals.get(s, (0, 0.0))[1] * 1e3!r}" for s in spans)
        + f"; user_annotation events {({s: len(v) for s, v in found.items()})}"
        + "; K1's launch " + "; ".join(
            f"{e['name']!r} at {e['ts']!r} us" for e in launch))
    if len(kernels) != 1 or not kernels[0].get("dur", 0) > 0:
        raise AssertionError("(s3) the trace lacks K1's one kernel event")
    if any(len(v) != 1 for v in found.values()):
        raise AssertionError("(s3) frame spans in the trace: "
                             f"{({s: len(v) for s, v in found.items()})}")
    raster = found["frame.raster"][0]
    lo, hi = raster["ts"], raster["ts"] + raster["dur"]
    if not launch or not all(lo <= e["ts"] and e["ts"] + e.get("dur", 0)
                             <= hi for e in launch):
        raise AssertionError(f"(s3) K1's launch {launch} lies outside "
                             f"frame.raster [{lo}, {hi}] us")


CLI_TOOLS = (
    ("arctool", ["unpack", "fixture_scene.arc", "-o", "unpacked"]),
    ("unpackall", ["."]),
    ("gmdtool", ["dump", "gui/fixture_messages.gmd"]),
    ("mtdeserializer", ["chara/fixture_character_skinned.chr"]),
    ("materialinfo", [".", "fixture_scene:model\\fixture_cube"]),
    ("schedulerdump", ["motion/fixture_timeline.sdl"]),
    ("shaderdump", ["custom_shaders/CustomShaderPackage.mfx"]),
    ("shaderpackagedump", [".", "custom_shaders/CustomShaderPackage"]),
    ("scriptparse", ["gui/fixture_messages.gmd", "--name-gmd",
                     "gui/fixture_messages.gmd"]),
)


def run_tools(root: Path, runs) -> list:
    """Start ``python -m mt_renderer_tpu_torch.cli.<tool> <args>`` for
    every (tool, args) of ``runs`` at once in ``root``; wait for all →
    their stdouts. Raises unless each exits 0."""
    import os

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [(tool, subprocess.Popen(
        [sys.executable, "-m", f"mt_renderer_tpu_torch.cli.{tool}", *args],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for tool, args in runs]
    outs, failed = [], []
    for tool, proc in procs:
        out, err = proc.communicate(timeout=300)
        outs.append(out)
        log(f"(s4) {tool}: exit {proc.returncode}, {len(out)} bytes out")
        if proc.returncode != 0:
            failed.append(f"{tool} exited {proc.returncode}:\n{err}")
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def phase_tools() -> None:
    """(s4) ``makefixtures`` into a temporary directory, then the other
    nine dump/pack CLIs on that tree as processes started together, each
    exiting 0; then ``arctool pack`` and ``gmdtool rebuild`` on what they
    wrote, giving back the archive's and the GMD's bytes."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        run_tools(root, [("makefixtures", ["tree"])])
        tree = root / "tree"
        outs = run_tools(tree, CLI_TOOLS)
        (tree / "m.json").write_text(outs[2])
        run_tools(tree, [("arctool", ["pack", "unpacked", "-o",
                                      "repacked.arc"]),
                         ("gmdtool", ["rebuild", "m.json", "-o", "re.gmd"])])
        same = ((tree / "repacked.arc").read_bytes()
                == (tree / "fixture_scene.arc").read_bytes(),
                (tree / "re.gmd").read_bytes()
                == (tree / "gui/fixture_messages.gmd").read_bytes())
    log(f"(s4) ten CLIs exit 0 in {time.perf_counter() - t0:.1f} s; "
        f"repacked archive and rebuilt GMD byte-equal: {same}")
    if not all(same):
        raise AssertionError("(s4) a round trip changed the bytes")


def phase_serving(device, case: dict, card: str) -> tuple:
    """(s1)-(s4) → (K1's launches on the served headline, K1's reading
    on its first request's inputs)."""
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    served = phase_served(case, "(s1) served headline", FRAMES, card)
    # K1 as the served program ran it: request 0's inputs, maxc default
    k1 = phase_kernel(dict(case, vp=served["vp"], bones=served["bones"],
                           maxc=rs.MAXC_DEFAULT))
    mip = headline_case(device, **MIP)
    phase_served(mip, "(s2) served mip headline", SERVED_MIP, card,
                 mipmap=True)
    del mip
    phase_profile(case, k1["ms"], card)
    phase_tools()
    log(f"serving phases (s1)-(s4) in {time.perf_counter() - t0:.1f} s")
    return served["launches"], k1


# ------------------------------------------------- slice 6: split frames

BANDS = (1, 2, 3, 8)        # (m1) band counts of the headline
SLOTS = 8                   # (m2), (m3), (m6) slots on the one card
SHARDS = (2, 4)             # (m4) geometry shards


def split_check(what: str, got, want) -> None:
    """A split frame against its single-device frame: color and depth bit
    for bit."""
    import torch

    n_c = int((got[0] != want[0]).sum())
    n_z = int((got[1] != want[1]).sum())
    cover = float((want[1] < 1.0).float().mean())
    log(f"{what}: {n_c} color and {n_z} depth elements differ from the "
        f"single-device frame; coverage {cover:.4f}")
    if n_c or n_z or not torch.equal(got[0], want[0]) or not 0.0 < cover:
        raise AssertionError(f"{what} differs from the single-device frame")


def phase_bands(case: dict) -> dict:
    """(m1) The headline band split over n slots of the card for n in
    BANDS: packed, taps from ``auto_tap_tiles(bands=n)``, each frame
    bit-equal (color and depth) to ``render_frame`` at the same maxc and
    its own taps, K1 launched n times; n = SLOTS unpacked and with
    ``setup_shard`` too. → K1's launches in the SLOTS-band frame (counts
    set to 0 just before it) and K1's reading on band SLOTS // 2."""
    from mt_renderer_tpu_torch.parallel import tiles
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    demo, scene, vp, bones = (case[k] for k in ("demo", "scene", "vp",
                                                "bones"))
    w, h, maxc = case["width"], case["height"], case["maxc"]
    kw = dict(width=w, height=h, maxc=maxc)
    want = dv.render_frame(scene, vp, bones, packed=True,
                           tap_tiles=case["taps"], **kw)
    launches = {}
    for n in BANDS:
        mesh = tiles.make_row_mesh(n, device=scene.device)
        taps = dv.auto_tap_tiles(demo.batch, vp, bones, width=w, height=h,
                                 bands=n)
        bkw = dict(kw, mesh=mesh, packed=True, tap_tiles=taps)
        reset_launches()
        got = tiles.render_frame_multichip(scene, vp, bones, **bkw)
        k1 = rs.raster_fwd.launches
        split_check(f"(m1) headline in {n} bands (tap_tiles={taps}), K1 "
                    f"launches {k1}", got, want)
        if k1 != n:
            raise AssertionError(f"(m1) {n} bands launched K1 {k1} times")
        launches[n] = k1
    mesh = tiles.make_row_mesh(SLOTS, device=scene.device)
    unpacked = dv.render_frame(scene, vp, bones, **kw)
    split_check(f"(m1) headline in {SLOTS} bands, unpacked",
                tiles.render_frame_multichip(scene, vp, bones, mesh=mesh,
                                             **kw), unpacked)
    split_check(f"(m1) headline in {SLOTS} bands, setup_shard",
                tiles.render_frame_multichip(
                    scene, vp, bones, mesh=mesh, packed=True, setup_shard=True,
                    tap_tiles=dv.auto_tap_tiles(demo.batch, vp, bones,
                                                width=w, height=h,
                                                bands=SLOTS), **kw), want)
    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError("(m1) overflow")
    _, args, (pw, pb), _ = band_args(scene, vp, bones, w, h, SLOTS, SLOTS // 2,
                                  maxc)
    reading = k1_reading(args, dict(width=pw, height=pb, w_eps=dv.W_EPS),
                         f"headline band {SLOTS // 2} of {SLOTS}, tap")
    log(f"(m1) in {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches[SLOTS], **reading)


def phase_banded_world(device) -> dict:
    """(m2) The world (280 buildings, mipmapped, palette on the card) in
    SLOTS bands with the tri pool and with the bc7 pool, each bit-equal
    to its single-device frame (taps from ``auto_tap_tiles(bands=)``),
    K1 launched SLOTS times. → K1's launches in the tri pool's banded
    frame and its mtap reading on band SLOTS // 2."""
    from mt_renderer_tpu_torch.entry import world_case
    from mt_renderer_tpu_torch.parallel import tiles
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    mesh = tiles.make_row_mesh(SLOTS, device=device)
    out = {}
    for pool in ("tri", "bc7"):
        case = world_case(device, pool_mode=pool, **WORLD)
        w, h = case.width, case.height
        vp, host_pal = case.view_proj(), case.bone_mats(0.0)
        pal = case.bone_mats_device(0.0)
        maxc = dv.auto_maxc(case.batch, vp, host_pal, width=w, height=h)
        kw = dict(width=w, height=h, maxc=maxc, mipmap=True, packed=True)
        taps = dv.auto_tap_tiles(case.batch, vp, host_pal, width=w,
                                 height=h, bands=SLOTS)
        want = dv.render_frame(case.scene, vp, pal, tap_tiles=dv.
                               auto_tap_tiles(case.batch, vp, host_pal,
                                              width=w, height=h), **kw)
        reset_launches()
        got = tiles.render_frame_multichip(case.scene, vp, pal, mesh=mesh,
                                           tap_tiles=taps, **kw)
        k1 = rs.raster_fwd.launches
        split_check(f"(m2) {pool} world in {SLOTS} bands (tap_tiles="
                    f"{taps}), K1 launches {k1}", got, want)
        if k1 != SLOTS:
            raise AssertionError(f"(m2) {pool} world launched K1 {k1} times")
        out[pool] = k1
        if pool == "tri":
            _, args, (pw, pb), _ = band_args(case.scene, vp, pal, w, h, SLOTS,
                                          SLOTS // 2, maxc)
            reading = k1_reading(args, dict(width=pw, height=pb,
                                            w_eps=dv.W_EPS, mode="mtap"),
                                 f"world band {SLOTS // 2} of {SLOTS}, mtap")
        del case
    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError("(m2) overflow")
    log(f"(m2) in {time.perf_counter() - t0:.1f} s")
    return dict(launches=out["tri"], **reading)


def phase_banded_peel(device) -> dict:
    """(m3) The glass headline's split peel, L = LAYERS, in SLOTS bands
    with the cap pair from ``measure_live_tap_tiles(mode="split",
    bands=SLOTS)``, bit-equal to ``render_frame_peeled(peel_mode=
    "split")`` at its own caps; K1 and K2 launched SLOTS times each. →
    K2's launches in that frame and K2's reading on band SLOTS // 2 (the
    translucent set behind the band's opaque z)."""
    from mt_renderer_tpu_torch.parallel import tiles
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    glass = headline_case(device, **GLASS)
    scene, vp, bones = glass["scene"], glass["vp"], glass["bones"]
    w, h, maxc = glass["width"], glass["height"], glass["maxc"]
    kw = dict(width=w, height=h, maxc=maxc, packed=True)
    mkw = dict(width=w, height=h, maxc=maxc, layers=LAYERS, mode="split")
    caps = dv.measure_live_tap_tiles(scene, vp, bones, bands=SLOTS, **mkw)
    want = dv.render_frame_peeled(
        scene, vp, bones, layers=LAYERS, peel_mode="split",
        tap_tiles=dv.measure_live_tap_tiles(scene, vp, bones, **mkw), **kw)
    mesh = tiles.make_row_mesh(SLOTS, device=device)
    reset_launches()
    got = tiles.render_frame_multichip(scene, vp, bones, mesh=mesh,
                                       peel_layers=LAYERS, tap_tiles=caps,
                                       **kw)
    k1, k2 = rs.raster_fwd.launches, rs.raster_fwd_ml.launches
    split_check(f"(m3) glass split peel L={LAYERS} in {SLOTS} bands (caps "
                f"{caps}), K1 launches {k1}, K2 launches {k2}", got, want)
    if (k1, k2) != (SLOTS, SLOTS):
        raise AssertionError(f"(m3) launches K1 {k1}, K2 {k2}")
    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError("(m3) overflow")
    reading = k2_split_reading(glass, SLOTS, SLOTS // 2,
                               f"glass band {SLOTS // 2} of {SLOTS}")
    log(f"(m3) in {time.perf_counter() - t0:.1f} s")
    return dict(launches=k2, k1=k1, **reading)


def phase_geomsplit(case: dict) -> dict:
    """(m4) The headline's geometry split over n slots of the card for n
    in SHARDS, packed at the single frame's caps, bit-equal to
    ``render_frame``; K1 launched n times. → K1's launches in the
    SHARDS[-1]-shard frame and K1's reading on its shard 0 (a triangle
    subset over the full frame)."""
    from mt_renderer_tpu_torch.parallel import tiles
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t0 = time.perf_counter()
    scene, vp, bones = case["scene"], case["vp"], case["bones"]
    w, h = case["width"], case["height"]
    kw = dict(width=w, height=h, maxc=case["maxc"], packed=True,
              tap_tiles=case["taps"])
    want = dv.render_frame(scene, vp, bones, **kw)
    launches = 0
    for n in SHARDS:
        mesh = tiles.make_row_mesh(n, device=scene.device)
        reset_launches()
        got = tiles.render_frame_geomsplit(scene, vp, bones, mesh=mesh, **kw)
        launches = rs.raster_fwd.launches
        split_check(f"(m4) headline in {n} geometry shards, K1 launches "
                    f"{launches}", got, want)
        if launches != n:
            raise AssertionError(f"(m4) {n} shards launched K1 {launches} "
                                 "times")
    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError("(m4) overflow")
    pw, ph = dv._padded(w, h)
    cols, bbox = dv.setup_packed_cols(scene, dv.vertex_stage(scene, vp,
                                                             bones), w, h)
    shard_t = tiles.cdiv_mult(cols.shape[1], SHARDS[-1], 384)
    cols_s = cols[:, :shard_t]
    bbox_s = tuple(b[:shard_t // 32] for b in bbox)
    lists, glists, counts, _ = rs.prebin(cols_s, bbox_s, 0, 0, width=pw,
                                         height=ph, maxc=case["maxc"])
    reading = k1_reading((cols_s, lists, glists, counts, (0, 0)),
                         dict(width=pw, height=ph, w_eps=dv.W_EPS),
                         f"headline shard 0 of {SHARDS[-1]}, tap")
    log(f"(m4) in {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, **reading)


def phase_multihost(device) -> None:
    """(m5) Two processes sharing the card over a gloo group (file
    rendezvous in a temporary directory):
    ``mt_renderer_tpu_torch.tools.multihost_demo`` at the headline size,
    each rank's rows of the packed, peeled (L = LAYERS), mipmapped and
    sharded-setup band frames bit-equal to its own single-device frame,
    the geometry split's frame likewise, ``gather_full_frame`` the whole
    frame; both print MULTIHOST OK."""
    import os
    import tempfile

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    with tempfile.TemporaryDirectory() as tmp:
        rdv = (Path(tmp) / "rdv").as_uri()
        argv = ["--nproc", "2", "--coordinator", rdv, "--device",
                str(device), "--width", str(HEADLINE["width"]), "--height",
                str(HEADLINE["height"]), "--instances",
                str(HEADLINE["instances"]), "--subdiv",
                str(HEADLINE["subdiv"]), "--peel", str(LAYERS), "--mipmap",
                "--setup-shard", "--geomsplit", "--gather", "5"]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mt_renderer_tpu_torch.tools."
             "multihost_demo", "--proc", str(r), *argv], cwd=tmp, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=300)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    for r, (proc, out) in enumerate(zip(procs, outs)):
        for line in out.strip().splitlines():
            log(f"(m5) rank {r}: {line}")
        if proc.returncode != 0 or not out.strip().endswith("MULTIHOST OK"):
            raise AssertionError(f"(m5) rank {r} exited {proc.returncode}")
    log(f"(m5) two processes on {device} in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_dryrun(device, legs: dict) -> None:
    """(m6) ``entry.dryrun_multichip(SLOTS)`` on the card (every leg
    bit-equal to its single-device frame, no overflow), and the bench's
    ``multichip_1dev`` verify leg from (h)."""
    from mt_renderer_tpu_torch import entry

    t0 = time.perf_counter()
    out = entry.dryrun_multichip(SLOTS, device)
    log(f"(m6) dryrun_multichip({SLOTS}): {json.dumps(out)} in "
        f"{time.perf_counter() - t0:.1f} s; multichip_1dev leg "
        f"{json.dumps(legs['multichip_1dev'])}")
    if not legs["multichip_1dev"]["passed"]:
        raise AssertionError("(m6) the multichip_1dev leg failed")


# ------------------------------------- the multipass peel, the scan backend


def bit_equal(got, want, what: str) -> float:
    """Every output of a raster equal to its plain version's, bit for bit
    (ids, z and every plane). Returns the max abs error (0.0)."""
    import torch

    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a.shape != b.shape or a.dtype != b.dtype
           or not torch.equal(a.contiguous().view(torch.int32),
                              b.contiguous().view(torch.int32))]
    if len(got) != len(want) or bad:
        raise AssertionError(f"{what}: outputs {bad} differ from the plain "
                             "version")
    return max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))


def phase_multipass(case: dict, what: str, mipmap: bool = False,
                    lighting: bool = False) -> dict:
    """(p1)/(p2) The multipass peel (L = LAYERS) on the case: one frame
    through ``render_frame_peeled(peel_mode="multipass")`` with the
    launch counts set to 0 just before it (K1 LAYERS times: the tap, or
    mipmapped the attrs epilogue, with zlow on every pass but the first),
    then every pass of the same frame recorded and held to its plain
    version on its own inputs, bit for bit; the frame against the ml
    peel at L = LAYERS (coverage exact, the golden rule); K1 on pass 1's
    inputs (a zlow pass) timed against its plain version, with its
    breakdown → a record's readings."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    w, h = case["width"], case["height"]
    kw = dict(width=w, height=h, layers=LAYERS, maxc=case["maxc"],
              mipmap=mipmap, lighting=lighting)
    args = (case["scene"], case["vp"], case["bones"])
    rs.flush_overflow_checks()
    reset_launches()
    color, depth = dv.render_frame_peeled(*args, peel_mode="multipass", **kw)
    launches = rs.raster_fwd.launches
    rs.flush_overflow_checks()
    if launches != LAYERS or rs.OVERFLOW_EVENTS:
        raise AssertionError(f"{what}: {launches} K1 launches (want "
                             f"{LAYERS}), overflow {rs.OVERFLOW_EVENTS}")

    calls = []

    def recording(*a, **k):
        out = rs.raster_fwd(*a, **k)
        calls.append((a, k, out))
        return out

    again, again_d, _ = dv._render_frame_peeled_core(
        *args, clear_color=(255, 255, 255, 255), peel_mode="multipass",
        tap_tiles=None, raster=recording, **kw)
    if not (torch.equal(again.view(torch.uint8).reshape(h, w, 4), color)
            and torch.equal(again_d, depth)):
        raise AssertionError(f"{what}: the recorded frame differs")
    err, modes = 0.0, []
    for i, (a, k, out) in enumerate(calls):
        modes.append(f"{k.get('mode', 'tap')}"
                     f"{'+zlow' if k['zlow'] is not None else ''}"
                     f"{'+lit' if k['light'] is not None else ''}")
        err = max(err, bit_equal(out, rs.raster_fwd_reference(*a, **k),
                                 f"{what}, pass {i}"))
    torch.cuda.synchronize()
    ml, ml_d = dv.render_frame_peeled(*args, peel_mode="ml", **kw)
    n_cov = int(((depth < 1.0) != (ml_d < 1.0)).sum())
    share, n_diff = golden_share(color.cpu().numpy(), ml.cpu().numpy())
    cover = [float((c[2][1] >= 0).float().mean()) for c in calls]
    log(f"{what}: L={LAYERS}, K1 launches {launches} ({', '.join(modes)}), "
        f"each bit-equal to its plain version; coverage per pass "
        f"{[round(c, 4) for c in cover]}; vs the ml peel: {n_cov} coverage "
        f"mismatches, {share:.6f} of pixels off by > 1 ({n_diff} differ)")
    if n_cov or share > GOLDEN_SHARE or not cover[0] > 0.0 \
            or not bool(torch.isfinite(depth).all()):
        raise AssertionError(f"{what}: the frame is wrong")

    a, k, out = calls[1]
    kernel_ms = graph_ms(lambda: rs.raster_fwd(*a, **k))
    plain_ms = cuda_ms(lambda: rs.raster_fwd_reference(*a, **k), warmup=1,
                       reps=3)
    log(f"raster_{modes[1].replace('+', '_')}_kernel_ms {kernel_ms!r}")
    log(f"raster_{modes[1].replace('+', '_')}_plain_ms {plain_ms!r}")
    bnd = k1_breakdown(a, k, out, f"{what}, pass 1, {modes[1]}")
    return dict(launches=launches, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, **bnd)


def phase_multipass_main(glass: dict) -> dict:
    """(p3) FRAMES frames of ``FrameEngine(peel=LAYERS,
    peel_mode="multipass")`` on the glass headline, yaw and bones varying
    as in phase 5, the launch counts set to 0 just before: LAYERS K1
    launches every frame, no overflow, the unpacked frame, frame 0 equal
    to ``render_frame_peeled`` at the engine's cap → the launches."""
    import torch

    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import engine as en
    from mt_renderer_tpu_torch.render import raster as rs

    w, h, demo = glass["width"], glass["height"], glass["demo"]
    cam = demo.camera
    base_yaw = cam.yaw
    eng = en.FrameEngine(demo.scene, demo.batch, width=w, height=h,
                         peel=LAYERS, peel_mode="multipass")
    rs.flush_overflow_checks()
    per_frame = []
    reset_launches()
    for t in range(FRAMES):
        before = rs.raster_fwd.launches
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        vp, bones = demo.view_proj(), demo.bone_mats(0.3 * t)
        color, depth = eng.render(vp, bones)
        per_frame.append(rs.raster_fwd.launches - before)
        if t == 0:
            first = (color, depth, vp, bones, eng.maxc)
    launches = rs.raster_fwd.launches
    cam.yaw = base_yaw
    eng.check()
    rs.flush_overflow_checks()
    color0, depth0, vp0, bones0, maxc0 = first
    want, want_d = dv.render_frame_peeled(
        demo.scene, vp0, bones0, width=w, height=h, layers=LAYERS,
        maxc=maxc0, peel_mode="multipass")
    log(f"multipass main path: {FRAMES} frames, K1 launches {launches} "
        f"(per frame {sorted(set(per_frame))}), overflow events "
        f"{rs.OVERFLOW_EVENTS}, maxc={eng.maxc}, packed {eng.packed}; frame "
        f"0 equal to render_frame_peeled: "
        f"{bool(torch.equal(color0, want) and torch.equal(depth0, want_d))}")
    if set(per_frame) != {LAYERS} or rs.OVERFLOW_EVENTS or eng.packed \
            or tuple(color0.shape) != (h, w, 4) \
            or not (torch.equal(color0, want) and torch.equal(depth0, want_d)):
        raise AssertionError("the multipass main path is wrong")
    return dict(launches=launches)


def offedge_mismatch(depth, ref_depth) -> int:
    """Coverage mismatches of two frames off ``ref_depth``'s coverage
    edge (``verify.coverage_edge``)."""
    from mt_renderer_tpu_torch import verify

    a = (depth < 1.0).cpu().numpy()
    b = (ref_depth < 1.0).cpu().numpy()
    return int(((a != b) & ~verify.coverage_edge(b)).sum())


def phase_scan(device) -> dict:
    """(c1) The scan backend at 1920x1080 on the demo scene ``SCAN`` (64
    instances at subdiv 2, 3,072 triangles): single, ``ml``-peeled (L =
    LAYERS),
    mipmapped, lit frames, each against ``render_frame(backend="pallas")``
    (or its ml peel) under the golden rule with no coverage mismatch off
    the edge; the bc1 and the bc7 pool's frames without mipmap (which the
    binned raster refuses), each equal, bit for bit, to the scan frame of
    a quad pool of its decoded chains; the scan band split over SLOTS
    slots and the scan geometry split over 2 shards, each equal to the
    scan frame bit for bit → the triangle counts."""
    import torch

    from mt_renderer_tpu_torch.parallel import tiles
    from mt_renderer_tpu_torch.render import device as dv
    from mt_renderer_tpu_torch.render import raster as rs

    t_all = time.perf_counter()
    case = headline_case(device, **SCAN, phase=0.6)
    w, h, scene = case["width"], case["height"], case["scene"]
    args = (scene, case["vp"], case["bones"])
    size = dict(width=w, height=h)
    n_tris = scene.tri_valid.shape[0]
    out = dict(tris=len(case["demo"].batch.tris), padded=n_tris)
    lit = dv.upload(with_normals(case["demo"].batch), device=device)
    frames = {}
    for name, sc, kw in (("single", scene, {}), ("mipmap", scene,
                                                 dict(mipmap=True)),
                         ("lit", lit, dict(lighting=True))):
        t0 = time.perf_counter()
        frames[name] = dv.render_frame(sc, *args[1:], backend="scan", **size,
                                       **kw)
        torch.cuda.synchronize()
        pallas = dv.render_frame(sc, *args[1:], maxc=case["maxc"], **size,
                                 **kw)
        share, n_diff = golden_share(frames[name][0].cpu().numpy(),
                                     pallas[0].cpu().numpy())
        n_off = offedge_mismatch(frames[name][1], pallas[1])
        log(f"scan {name} frame {w}x{h}, {n_tris} tris "
            f"({time.perf_counter() - t0:.2f} s with the pallas frame): vs "
            f"pallas {share:.6f} of pixels off by > 1 ({n_diff} differ), "
            f"{n_off} coverage mismatches off the edge; coverage "
            f"{float((frames[name][1] < 1.0).float().mean()):.4f}")
        if share > GOLDEN_SHARE or n_off \
                or frames[name][0].dtype != torch.uint8 \
                or not 0.0 < float((frames[name][1] < 1.0).float().mean()):
            raise AssertionError(f"scan {name} frame is wrong")
    t0 = time.perf_counter()
    peel = dv.render_frame_peeled(*args, backend="scan", layers=LAYERS,
                                  **size)
    ml = dv.render_frame_peeled(*args, maxc=case["maxc"], layers=LAYERS,
                                **size)
    share, n_diff = golden_share(peel[0].cpu().numpy(), ml[0].cpu().numpy())
    n_off = offedge_mismatch(peel[1], ml[1])
    log(f"scan ml peel L={LAYERS} ({time.perf_counter() - t0:.2f} s with the "
        f"pallas ml peel): vs pallas {share:.6f} off by > 1, {n_off} "
        f"coverage mismatches off the edge")
    if share > GOLDEN_SHARE or n_off:
        raise AssertionError("scan peeled frame is wrong")
    for mode in ("bc1", "bc7"):
        bc = dv.upload(case["demo"].batch, mode, device=device)
        quad = dv.upload(case["demo"].batch, device=device,
                         mip_chains=decoded_chains(case["demo"].batch, mode))
        got = dv.render_frame(bc, *args[1:], backend="scan", **size)
        want = dv.render_frame(quad, *args[1:], backend="scan", **size)
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        log(f"scan {mode} frame without mipmap vs the quad pool of its "
            f"decoded chains: bit-equal {same}")
        if not same:
            raise AssertionError(f"scan {mode} frame differs")
    single = frames["single"]
    for split, n in ((tiles.render_frame_multichip, SLOTS),
                     (tiles.render_frame_geomsplit, 2)):
        t0 = time.perf_counter()
        got = split(*args, mesh=tiles.make_row_mesh(n, device=device),
                    backend="scan", **size)
        same = torch.equal(got[0], single[0]) and torch.equal(got[1],
                                                              single[1])
        log(f"scan {split.__name__} over {n} slots "
            f"({time.perf_counter() - t0:.2f} s): bit-equal to the scan "
            f"frame {same}")
        if not same:
            raise AssertionError(f"scan {split.__name__} differs")
    rs.flush_overflow_checks()
    log(f"scan phase (c1): {out['tris']} tris, {n_tris} padded, "
        f"{n_tris // dv.DEFAULT_CHUNK} steps of {dv.DEFAULT_CHUNK}, {w}x{h}, "
        f"{time.perf_counter() - t_all:.1f} s")
    return out


def phase_split_frames(device, case: dict, legs: dict) -> dict:
    """(m1)-(m6) → each banded or sharded record's launches and
    readings."""
    t0 = time.perf_counter()
    out = dict(bands=phase_bands(case),
               world=phase_banded_world(device),
               peel=phase_banded_peel(device),
               geomsplit=phase_geomsplit(case))
    phase_multihost(device)
    phase_dryrun(device, legs)
    log(f"split-frame phases (m1)-(m6) in {time.perf_counter() - t0:.1f} s")
    return out


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
    mp = phase_multipass(glass, "(p1) glass multipass")
    mp_run = phase_multipass_main(glass)
    del glass
    mip = headline_case(device, **MIP)
    k1_mip = phase_mip_kernel(mip)
    mip_run = phase_main(mip, mipmap=True, lighting=True)
    glass_mip = headline_case(device, **GLASS_MIP)
    k2_mip, k2_full = phase_ml_mip_kernel(glass_mip, mip)
    full_launches = split_equals_ml(mip, LAYERS, "opaque mip+light headline",
                                    mipmap=True, lighting=True)
    peel_mip_run = phase_peel_main(glass_mip, mipmap=True, lighting=True)
    mp_mip = phase_multipass(glass_mip, "(p2) peeled mip+light multipass",
                             mipmap=True, lighting=True)
    del glass_mip, mip
    phase_world_legs(device)
    world_run = phase_world_main(device)
    bc1_world = phase_bcn_world(device, "bc1")
    bc1_peel = phase_bcn_peel(device, "bc1")
    phase_narrow(case)
    phase_helpers(case)
    k3 = phase_micro(case)
    roof = phase_roofline(device)
    k4 = phase_bilin(device)
    bc7_world = phase_bcn_world(device, "bc7", earlier=bc1_world["stats"])
    bc7_kernel = phase_bc7_multimode(device)
    bc7_peel = phase_bcn_peel(device, "bc7")
    legs = phase_bench_legs(device)
    phase_scan(device)
    viewer = phase_viewers(device, dev_info["card"])
    served_launches, k1_served = phase_serving(device, case,
                                               dev_info["card"])
    split = phase_split_frames(device, case, legs)
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
        raster_record("raster_fwd", "mtap (bc1 world, FrameEngine)",
                      bc1_world["launches"], bc1_world),
        raster_record("raster_fwd", "mtap (bc7 world, FrameEngine)",
                      bc7_world["launches"], bc7_world),
        raster_record("raster_fwd",
                      f"mtap (modelviewer --demo {VIEWER_WORLD} --hud)",
                      viewer["launches"], viewer),
        raster_record("raster_fwd", "tap (served artifact)", served_launches,
                      k1_served),
        raster_record("raster_fwd", f"tap (headline band split, {SLOTS} "
                      "slots)", split["bands"]["launches"], split["bands"]),
        raster_record("raster_fwd", f"mtap (world band split, {SLOTS} "
                      "slots)", split["world"]["launches"], split["world"]),
        raster_record("raster_fwd", f"tap (headline geometry split, "
                      f"{SHARDS[-1]} shards)", split["geomsplit"]["launches"],
                      split["geomsplit"]),
        raster_record("raster_fwd", f"tap+zlow (glass multipass, L={LAYERS})",
                      mp_run["launches"], mp),
        raster_record("raster_fwd", f"attrs+zlow+lit (peeled mip+light "
                      f"multipass, L={LAYERS})", mp_mip["launches"], mp_mip),
        raster_record("raster_fwd_ml", "tap", peel_run["k2"], k2),
        raster_record("raster_fwd_ml", "mtap+lit", peel_mip_run["k2"],
                      k2_mip),
        raster_record("raster_fwd_ml",
                      "full (opaque mip+light headline, ml peel)",
                      full_launches, k2_full),
        raster_record("raster_fwd_ml",
                      "mtap+lit (bc1 glass headline, split peel)",
                      bc1_peel["launches"], bc1_peel),
        raster_record("raster_fwd_ml",
                      "mtap+lit (bc7 glass headline, split peel)",
                      bc7_peel["launches"], bc7_peel),
        raster_record("raster_fwd_ml", f"tap (glass split peel, {SLOTS} "
                      "bands)", split["peel"]["launches"], split["peel"]),
        record("raster_micro", MICRO_SOURCE, MICRO_REPLACES,
               roof["launches"], k3, rows=k3["rows"],
               surviving=k3["surviving"], test_ns=sol["test_ns"],
               eval_ns=sol["eval_ns"]),
        record("bilin_swar", SWAR_SOURCE, SWAR_REPLACES, k4["launches"], k4),
        record("bc7_trilinear", BC7_SOURCE, BC7_REPLACES,
               bc7_kernel["launches"], bc7_kernel, taps=bc7_kernel["taps"],
               rows=bc7_kernel["rows"],
               per_tap_bound_ms=bc7_kernel["per_tap_bound_ms"]),
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
