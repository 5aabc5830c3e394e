"""The reference bench's verify legs, on the port.

``bench_legs`` is the counterpart of ``bench.py::verify`` (``:114-268``):
the skinned demo batch (256x256, 9 instances at subdiv 2, the demo
camera, bones at phase 0.6) rendered by the port on a device, each
production path held to its oracle:

- ``pallas``: the packed single-layer frame (dense taps) against
  ``render.cpu_reference`` (the NumPy oracle) under the reference's
  bound (``oracle_bound``);
- ``peel_pallas``: the ml peel at L = 3 (dense): its nearest layer
  reproduces the single-layer frame, with no coverage mismatch off the
  oracle's coverage edge and at most 0.3% of pixels with a channel off
  by more than 1;
- ``packed``: the frame with its taps compacted to ``auto_tap_tiles``
  rows equals the dense frame bit for bit, color and depth;
- ``peel_packed``: the ml peel compacted to ``measure_live_tap_tiles``
  rows equals the dense peel bit for bit, color and depth;
- ``mipmap_packed``: the mipmapped frame (compacted trilinear shade, the
  quad pool) covers exactly the ``pallas`` frame's pixels, and its color
  is under the golden rule against the same frame through the plain
  raster (``raster_fwd_reference``). This is weaker than the
  reference's leg, which holds the frame against its scan backend's
  trilinear (a second, independent sampler); the port keeps no scan
  backend, by decision;
- ``peel_split``: the split peel, compacted to its measured (opaque,
  translucent) caps, equals the dense ml peel bit for bit, color and
  depth (the scene is opaque);
- ``multichip_1dev``: the band split over a one-slot row mesh on the
  same device (``parallel.tiles.render_frame_multichip``, packed, the
  taps compacted to ``auto_tap_tiles`` rows) against the ``pallas``
  frame under the golden rule: no coverage mismatch off the oracle's
  coverage edge and at most 0.3% of pixels with a channel off by more
  than 1 (``bench.py:251-266``).

``scan`` and ``peel_scan`` (the scan backend) are not ported, by
decision.

``world_legs`` is the counterpart of ``bench.py::verify_world``: the
world's heterogeneous paths (more than 128 material slots, mixed mip
tables in one texel pool, per-instance bone palettes) rendered by the
port on a device and held to an oracle at the reference's sizes:

- ``invariants``: more than 128 materials, at least 8 mip levels, at
  least 4 texture sizes, and the per-slot tints (``mat_color``) on the
  device equal to the host's;
- ``world_packed``: the packed bilinear frame at the verify camera
  against ``render.cpu_reference`` (the NumPy oracle) under the
  reference's bound: no coverage mismatch off the coverage edge, at most
  0.3% of pixels with a channel off by more than 1 and at most 0.3% of
  pixels with a coverage mismatch, on a view that covers something;
- ``world_mipmap_packed``: the mipmapped frame from the tri pool against
  the same frame through the plain raster (``raster_fwd_reference``) on
  the same inputs: coverage equal, color under the golden rule (the
  reference holds it against its scan backend, which the port does not
  carry, by decision);
- ``world_chars_packed``: the bird's-eye view of the character row
  against the oracle, under the same bound as ``world_packed``;
- ``palette_animates``: the frames at scheduler frames 12 and 30 differ.
"""

from __future__ import annotations

import numpy as np

from .app.camera import Camera
from .entry import world_case
from .parallel import tiles
from .render import cpu_reference
from .render import device as dv
from .render import raster as rs
from .scene import demo

# bench.py:114
BENCH_LEGS = dict(width=256, height=256, instances=9, subdiv=2)
PEEL_LAYERS = 3
# bench.py:286-287
WORLD_LEGS = dict(buildings=130, characters=3, variants=6, terrain_subdiv=3,
                  building_subdivs=(1, 2))
SHARE = 0.003


def coverage_edge(cov: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood holds both covered and uncovered
    oracle pixels: the only place float-rounding differences may show."""
    pad = np.pad(cov, 1, mode="edge")
    any_cov = np.zeros_like(cov, bool)
    all_cov = np.ones_like(cov, bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            n = pad[dy:dy + cov.shape[0], dx:dx + cov.shape[1]]
            any_cov |= n
            all_cov &= n
    return any_cov & ~all_cov


def oracle_bound(got, got_d, want, want_d) -> dict:
    """``bench.py``'s bound of a packed frame (tensor, int32 bits) and its
    depth against the oracle's (H, W, 4) u8 frame and depth."""
    got = dv.unpack_rgba(got)
    got_d = got_d.cpu().numpy()
    cov_mis = (got_d < 1.0) != (want_d < 1.0)
    offedge = int((cov_mis & ~coverage_edge(want_d < 1.0)).sum())
    cdiff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    bad = float((cdiff > 1).mean())
    cover = float((want_d < 1.0).mean())
    return dict(coverage=cover, coverage_mismatch_px=int(cov_mis.sum()),
                offedge_mismatch_px=offedge, color_mismatch_share=bad,
                passed=bool(offedge == 0 and bad <= SHARE
                            and cov_mis.mean() <= SHARE and cover > 0.0))


def world_legs(device, *, width: int = 256, height: int = 144,
               **world_kw) -> dict:
    """Every leg on ``device`` → {leg: readings with ``passed``}, and
    ``passed`` over all. ``world_kw`` overrides ``WORLD_LEGS``."""
    kw = dict(WORLD_LEGS, **world_kw)
    case = world_case(device, width=width, height=height, pool_mode="quad",
                      **kw)
    tri = dv.upload(case.batch, "tri", device=device)
    ws, batch = case.world, case.batch
    pal = case.bone_mats(12.0)
    out: dict = {"materials": ws.info["materials"], "tris": ws.info["tris"]}

    out["invariants"] = dict(passed=bool(
        ws.info["materials"] > 128 and case.scene.num_mips >= 8
        and len(ws.info["tex_sizes"]) >= 4
        and np.array_equal(case.scene.mat_color.cpu().numpy(),
                           ws.mat_color)))

    # the verify camera (bench.py:299-300)
    cam = Camera(position=[0.0, -26.0, 8.0], yaw=0.0, pitch=-30.0,
                 far=120.0)
    cam.aspect = width / height
    vp = np.asarray(cam.view_proj())
    maxc = dv.auto_maxc(batch, vp, pal, width=width, height=height)
    taps = dv.auto_tap_tiles(batch, vp, pal, width=width, height=height)
    fkw = dict(width=width, height=height, packed=True, maxc=maxc,
               tap_tiles=taps)
    want, want_d = cpu_reference.render(batch, vp, width, height,
                                        bone_mats=pal)
    out["world_packed"] = oracle_bound(
        *dv.render_frame(case.scene, vp, pal, **fkw), want, want_d)

    got, got_d = dv.render_frame(tri, vp, pal, mipmap=True, **fkw)
    plain, plain_d, _ = dv._render_frame_core(
        tri, vp, pal, width=width, height=height,
        clear_color=(255, 255, 255, 255), maxc=maxc, tap_tiles=taps,
        mipmap=True, raster=rs.raster_fwd_reference)
    diff = np.abs(dv.unpack_rgba(got).astype(np.int32)
                  - dv.unpack_rgba(plain).astype(np.int32)).max(-1)
    n_cov = int(((got_d < 1.0) != (plain_d < 1.0)).sum())
    out["world_mipmap_packed"] = dict(
        coverage_mismatch_px=n_cov,
        color_mismatch_share=float((diff > 1).mean()),
        passed=bool(n_cov == 0 and (diff > 1).mean() <= SHARE))

    # the bird's-eye camera over the character row (bench.py:369-372)
    side = int(np.ceil(np.sqrt(kw["buildings"])))
    cam2 = Camera(position=[0.0, -side * 1.6 - 2.0, 9.0], far=120.0)
    cam2.aspect = width / height
    vp2 = np.asarray(cam2.view_proj())
    want2, want_d2 = cpu_reference.render(batch, vp2, width, height,
                                          bone_mats=pal)
    ca, cad = dv.render_frame(case.scene, vp2, pal, **fkw)
    out["world_chars_packed"] = oracle_bound(ca, cad, want2, want_d2)
    cb, _ = dv.render_frame(case.scene, vp2, case.bone_mats(30.0), **fkw)
    out["palette_animates"] = dict(
        changed_px=int((ca != cb).sum()), passed=bool((ca != cb).any()))
    rs.flush_overflow_checks()
    out["passed"] = all(v["passed"] for v in out.values()
                        if isinstance(v, dict))
    return out



def bench_frames(device, *, width: int = 256, height: int = 256,
                 instances: int = 9, subdiv: int = 2) -> tuple:
    """Every frame ``bench_legs`` judges, rendered on ``device`` →
    (frames {name: (packed color (H, W) i32, depth (H, W) f32)}, with the
    oracle's (H, W, 4) u8 frame and depth under "oracle"; the tap caps
    {leg: caps})."""
    batch = demo.build_demo_batch(instances=instances, skinned=True,
                                  subdiv=subdiv)
    vp = np.asarray(demo.demo_camera(instances, width, height).view_proj())
    bones = demo.demo_bone_mats(0.6)
    scene = dv.upload(batch, device=device)
    size = dict(width=width, height=height)
    kw = dict(size, packed=True)
    peel = dict(kw, layers=PEEL_LAYERS)
    stt = dv.auto_tap_tiles(batch, vp, bones, **size)
    tt = dv.measure_live_tap_tiles(scene, vp, bones, layers=PEEL_LAYERS,
                                   **size)
    sps = dv.measure_live_tap_tiles(scene, vp, bones, layers=PEEL_LAYERS,
                                    mode="split", **size)
    frames = {
        "oracle": cpu_reference.render(batch, vp, width, height,
                                       bone_mats=bones),
        "pallas": dv.render_frame(scene, vp, bones, **kw),
        "peel_pallas": dv.render_frame_peeled(scene, vp, bones, **peel),
        "packed": dv.render_frame(scene, vp, bones, tap_tiles=stt, **kw),
        "peel_packed": dv.render_frame_peeled(scene, vp, bones,
                                              tap_tiles=tt, **peel),
        "mipmap_packed": dv.render_frame(scene, vp, bones, mipmap=True,
                                         tap_tiles=stt, **kw),
        "mipmap_plain": dv._render_frame_core(
            scene, vp, bones, clear_color=(255, 255, 255, 255), maxc=None,
            tap_tiles=stt, mipmap=True, raster=rs.raster_fwd_reference,
            **size)[:2],
        "peel_split": dv.render_frame_peeled(scene, vp, bones,
                                             peel_mode="split",
                                             tap_tiles=sps, **peel),
        "multichip_1dev": tiles.render_frame_multichip(
            scene, vp, bones, mesh=tiles.make_row_mesh(1, device=device),
            tap_tiles=stt, **kw),
    }
    rs.flush_overflow_checks()
    return frames, dict(packed=stt, peel_packed=tt, peel_split=sps)


def _frame_bound(got, got_d, ref, ref_d, edge) -> dict:
    """A packed frame against another: coverage mismatches off the
    oracle's coverage ``edge`` and the share of pixels with a channel off
    by more than 1."""
    cov_mis = (got_d < 1.0).cpu().numpy() != (ref_d < 1.0).cpu().numpy()
    diff = np.abs(dv.unpack_rgba(got).astype(np.int32)
                  - dv.unpack_rgba(ref).astype(np.int32)).max(-1)
    offedge = int((cov_mis & ~edge).sum())
    share = float((diff > 1).mean())
    return dict(coverage_mismatch_px=int(cov_mis.sum()),
                offedge_mismatch_px=offedge, color_mismatch_share=share,
                passed=bool(offedge == 0 and share <= SHARE))


def _bit_equal(got, got_d, ref, ref_d, caps) -> dict:
    n_px = int((got != ref).sum())
    n_z = int((got_d != ref_d).sum())
    return dict(tap_tiles=caps, color_mismatch_px=n_px,
                depth_mismatch_px=n_z, passed=n_px == 0 and n_z == 0)


def judge_bench_legs(frames: dict, caps: dict) -> dict:
    """``bench_frames``' frames → {leg: readings with ``passed``}, and
    ``passed`` over all."""
    want, want_d = frames["oracle"]
    edge = coverage_edge(want_d < 1.0)
    out: dict = {"pallas": oracle_bound(*frames["pallas"], want, want_d)}
    for leg in ("peel_pallas", "multichip_1dev"):
        out[leg] = _frame_bound(*frames[leg], *frames["pallas"], edge)
    for leg, ref in (("packed", "pallas"), ("peel_packed", "peel_pallas"),
                     ("peel_split", "peel_pallas")):
        out[leg] = _bit_equal(*frames[leg], *frames[ref], caps[leg])
    got, got_d = frames["mipmap_packed"]
    plain, _ = frames["mipmap_plain"]
    n_cov = int(((got_d < 1.0) != (frames["pallas"][1] < 1.0)).sum())
    diff = np.abs(dv.unpack_rgba(got).astype(np.int32)
                  - dv.unpack_rgba(plain).astype(np.int32)).max(-1)
    share = float((diff > 1).mean())
    out["mipmap_packed"] = dict(coverage_mismatch_px=n_cov,
                                color_mismatch_share=share,
                                passed=bool(n_cov == 0 and share <= SHARE))
    out["passed"] = all(v["passed"] for v in out.values())
    return out


def bench_legs(device, *, width: int = 256, height: int = 256,
               instances: int = 9, subdiv: int = 2) -> dict:
    """Every leg of ``bench.py::verify`` that the port carries, on
    ``device`` → {leg: readings with ``passed``}, and ``passed`` over
    all (the shape ``world_legs`` returns)."""
    return judge_bench_legs(*bench_frames(
        device, width=width, height=height, instances=instances,
        subdiv=subdiv))
