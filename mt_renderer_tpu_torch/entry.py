"""Entry point: the production render step on the flagship scene.

The counterpart of ``__graft_entry__.entry``: the textured + skinned
instanced demo scene through the binned tile raster with the in-kernel
tap epilogue, returning the packed frame. ``demo_case`` builds that
scene, and its glass variant with translucent instances, at any size,
and ``world_case`` the archive world with its animated characters, so
scripts reach both through the port alone. ``dryrun_multichip`` is the
counterpart of ``__graft_entry__.dryrun_multichip``: the split frames
of ``parallel.tiles`` over n slots of one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .scene import demo
from .scene import world as world_mod

from .render import device as dv


@dataclass
class DemoCase:
    """The skinned demo scene at one size: the host batch the cap
    predictors read, the scene uploaded to a device, and the camera that
    frames it."""
    batch: object               # host DrawBatch
    scene: dv.DeviceScene
    camera: object              # app.camera.Camera; its yaw may be moved
    width: int
    height: int

    def view_proj(self) -> np.ndarray:
        return np.asarray(self.camera.view_proj())

    @staticmethod
    def bone_mats(t: float) -> np.ndarray:
        """The demo's two-bone palette at animation phase ``t``."""
        return demo.demo_bone_mats(t)


def demo_case(device, *, instances: int, width: int, height: int,
              subdiv: int = 0, translucent: bool = False,
              cam_scale: float = 1.0, pool_mode: str = "quad") -> DemoCase:
    """``instances`` skinned, textured demo cubes (12·max(subdiv, 1)²
    triangles each) uploaded to ``device`` with the ``pool_mode`` texel
    pool ("quad", or "tri" for the trilinear frame), and a camera
    framing them at ``width`` x ``height``.

    ``translucent`` builds the glass variant: every 4th instance takes
    material slot 1, whose alpha is 0.5 (``demo.make_translucent``).
    ``cam_scale`` scales the camera position; 0.3 puts the camera inside
    the cube field, as the reference's dense and glass presets do."""
    batch = demo.build_demo_batch(instances=instances, skinned=True,
                                  subdiv=subdiv)
    if translucent:
        batch = demo.make_translucent(batch, instances)
    camera = demo.demo_camera(instances, width, height)
    camera.position = camera.position * cam_scale
    return DemoCase(batch=batch,
                    scene=dv.upload(batch, pool_mode, device=device),
                    camera=camera, width=width, height=height)


@dataclass
class WorldCase:
    """The archive world at one size: the ``WorldScene`` (per-slot
    tints, character placements, skeleton, timeline), its host batch,
    the scene uploaded to a device, the camera that frames it and the
    ``BoneAnimator`` that poses the characters."""
    world: world_mod.WorldScene
    batch: object               # host DrawBatch
    scene: dv.DeviceScene
    camera: object              # app.camera.Camera; its yaw may be moved
    animator: object            # scene.animation.BoneAnimator
    width: int
    height: int

    def view_proj(self) -> np.ndarray:
        return np.asarray(self.camera.view_proj())

    def bone_mats(self, frame: float) -> np.ndarray:
        """Every character's palette at scheduler ``frame``, on the host."""
        return self.world.bone_palette(self.animator.bone_mats(frame))

    def bone_mats_device(self, frame):
        """The same palette computed on the scene's device, where it stays
        (the same bits as ``bone_mats``)."""
        return self.world.bone_palette(
            self.animator.bone_mats_device(frame, self.scene.device))


def world_case(device, *, buildings: int, width: int, height: int,
               characters: int = 12, variants: int = 24,
               terrain_subdiv: int = 12,
               building_subdivs=(2, 3, 4, 5, 6, 8),
               tex_sizes=(16, 32, 64, 128, 256),
               pool_mode: str = "tri") -> WorldCase:
    """``scene.world.build_world`` (distinct parsed building models over
    mixed texture sizes ``tex_sizes``, one material slot per instance,
    ``characters`` 8-weight skinned characters on a ``.sdl`` timeline)
    uploaded to ``device`` with the ``pool_mode`` texel pool ("tri" by
    default: the mipmapped world's pool, as the reference bench picks it;
    "bc1" keeps the textures BC1-compressed on the device, "bc7"
    BC7-compressed as mode-6 content, as ``bench.py --pool bc7`` makes
    it), and the world camera at ``width`` x ``height``."""
    ws = world_mod.build_world(
        buildings=buildings, characters=characters, variants=variants,
        terrain_subdiv=terrain_subdiv, building_subdivs=building_subdivs,
        tex_sizes=tex_sizes)
    return WorldCase(world=ws, batch=ws.batch,
                     scene=dv.upload(ws.batch, pool_mode, device=device),
                     camera=world_mod.world_camera(width, height,
                                                   buildings=buildings),
                     animator=ws.animator(), width=width, height=height)


def entry(device):
    """(fn, example_args) — ``fn(scene, view_proj, bone_mats)`` renders
    one 256x256 packed frame (int32 RGBA8 bits) of the 16-instance
    skinned demo scene uploaded to ``device``."""
    case = demo_case(device, instances=16, width=256, height=256)

    def fn(scene, view_proj, bone_mats):
        color, _ = dv.render_frame(
            scene, view_proj, bone_mats, width=case.width,
            height=case.height, backend="pallas", packed=True)
        return color

    return fn, (case.scene, case.view_proj(), case.bone_mats(0.5))


# __graft_entry__.py:59-164: the headline band split at 1080p with
# bench-scale geometry (1024 instances at subdiv 3, 110,592 triangles),
# the smaller legs at 64 x 16n, the world at 512x256 with 140 buildings
DRYRUN = dict(width=1920, height=1080, instances=1024, subdiv=3,
              buildings=140, world_width=512, world_height=256)


def _split_equal(what: str, got, want) -> None:
    """A split frame against its single-device frame, bit for bit."""
    for g, w, part in zip(got, want, ("color", "depth")):
        if not torch.equal(g, w):
            n = int((g != w).sum())
            raise AssertionError(f"dryrun_multichip: {what} {part} differs "
                                 f"from the single-device frame ({n} "
                                 "elements)")


def dryrun_multichip(n_devices: int, device=None, **sizes) -> dict:
    """The split frames over ``n_devices`` slots of one device (default
    the first CUDA card; ``device="cpu"`` rehearses), each held bit for
    bit to the single-device frame → {leg: coverage} (and the caps it
    sized). ``sizes`` overrides ``DRYRUN``. The legs:

    * the band split at ``width`` x ``height`` (packed, the taps sized
      by ``auto_tap_tiles(bands=n)``);
    * the geometry split at 64 x 16n;
    * the banded split peel (L = 2, half the instances translucent),
      its cap pair from ``measure_live_tap_tiles(mode="split", bands=n)``;
    * the banded archive world (more than 128 material slots, mixed mip
      tables, animated palettes), mipmapped, with the tri pool and with
      the bc7 pool.

    Every leg ends with the overflow queue drained and no overflow."""
    from .parallel import tiles
    from .render import raster as rs

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device visible "
                               "(pass device='cpu' to rehearse there)")
        device = "cuda"
    cfg = dict(DRYRUN, **sizes)
    n = n_devices
    mesh = tiles.make_row_mesh(n, device=device)
    rs.flush_overflow_checks()
    before = rs.OVERFLOW_EVENTS
    out: dict = {}

    def leg(name, scene, vp, bones, split_kw, single_kw, single=None,
            split=tiles.render_frame_multichip):
        got = split(scene, vp, bones, mesh=mesh, **split_kw)
        want = (single or dv.render_frame)(scene, vp, bones, **single_kw)
        _split_equal(name, got, want)
        out[name] = float((got[1] < 1.0).float().mean())
        if out[name] <= 0.0:
            raise AssertionError(f"dryrun_multichip: {name} rendered "
                                 "nothing")

    w, h = cfg["width"], cfg["height"]
    case = demo_case(device, instances=cfg["instances"],
                     subdiv=cfg["subdiv"], width=w, height=h)
    vp, bones = case.view_proj(), case.bone_mats(0.5)
    size = dict(width=w, height=h, packed=True,
                maxc=dv.auto_maxc(case.batch, vp, bones, width=w, height=h))
    taps = dv.auto_tap_tiles(case.batch, vp, bones, width=w, height=h,
                             bands=n)
    leg("bands", case.scene, vp, bones, dict(size, tap_tiles=taps),
        dict(size, tap_tiles=dv.auto_tap_tiles(case.batch, vp, bones,
                                               width=w, height=h)))
    out["bands_tap_tiles"] = taps
    del case

    sh = 16 * n
    small = demo_case(device, instances=4, width=64, height=sh)
    svp, sbones = small.view_proj(), small.bone_mats(0.5)
    leg("geomsplit", small.scene, svp, sbones, dict(width=64, height=sh),
        dict(width=64, height=sh), split=tiles.render_frame_geomsplit)

    glass = demo.make_translucent(
        demo.build_demo_batch(instances=4, skinned=True), 4, fraction=0.5)
    gscene = dv.upload(glass, device=device)
    peel = dict(width=64, height=sh, layers=2)
    caps = dv.measure_live_tap_tiles(gscene, svp, sbones, mode="split",
                                     bands=n, **peel)
    leg("peel", gscene, svp, sbones,
        dict(width=64, height=sh, peel_layers=2, tap_tiles=caps),
        dict(peel, peel_mode="split",
             tap_tiles=dv.measure_live_tap_tiles(gscene, svp, sbones,
                                                 mode="split", **peel)),
        single=dv.render_frame_peeled)
    out["peel_caps"] = caps

    ww, wh, nb = cfg["world_width"], cfg["world_height"], cfg["buildings"]
    ws = world_mod.build_world(buildings=nb, characters=2, variants=6,
                               terrain_subdiv=4, building_subdivs=(2, 3),
                               tex_sizes=(16, 32, 64))
    if ws.info["materials"] <= 128 and nb >= 140:
        raise AssertionError(f"dryrun_multichip: the world has "
                             f"{ws.info['materials']} material slots")
    wvp = np.asarray(world_mod.world_camera(ww, wh, buildings=nb)
                     .view_proj())
    wpal = ws.bone_palette(ws.animator().bone_mats(np.float32(0.0)))
    wsize = dict(width=ww, height=wh, packed=True, mipmap=True,
                 maxc=dv.auto_maxc(ws.batch, wvp, wpal, width=ww,
                                   height=wh))
    wtaps = dv.auto_tap_tiles(ws.batch, wvp, wpal, width=ww, height=wh,
                              bands=n)
    for pool in ("tri", "bc7"):
        wscene = dv.upload(ws.batch, pool, mipmap=True, device=device)
        leg(f"world_{pool}", wscene, wvp, wpal, dict(wsize, tap_tiles=wtaps),
            dict(wsize, tap_tiles=dv.auto_tap_tiles(
                ws.batch, wvp, wpal, width=ww, height=wh)))
        del wscene
    out["world_tap_tiles"] = wtaps

    rs.flush_overflow_checks()
    out["overflow_events"] = rs.OVERFLOW_EVENTS - before
    if out["overflow_events"]:
        raise AssertionError(f"dryrun_multichip: {out['overflow_events']} "
                             "overflow events")
    print(f"dryrun_multichip: {n} slots on {torch.device(device)} OK — "
          f"{w}x{h} bands ({cfg['instances']} instances, subdiv "
          f"{cfg['subdiv']}), geomsplit, capped peel (caps {caps}), banded "
          f"world {ww}x{wh} ({ws.info['materials']} materials, "
          f"{ws.info['tris']} tris) on the tri and bc7 pools; coverage "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()
                      if isinstance(v, float)), flush=True)
    return out
