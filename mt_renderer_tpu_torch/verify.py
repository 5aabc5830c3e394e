"""The archive world's verify legs, on the port.

The counterpart of ``bench.py::verify_world``: the world's heterogeneous
paths (more than 128 material slots, mixed mip tables in one texel pool,
per-instance bone palettes) rendered by the port on a device and held to
an oracle at the reference's sizes:

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
from .render import cpu_reference
from .render import device as dv
from .render import raster as rs

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

