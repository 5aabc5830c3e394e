"""Entry point: the production render step on the flagship scene.

The counterpart of ``__graft_entry__.entry``: the textured + skinned
instanced demo scene through the binned tile raster with the in-kernel
tap epilogue, returning the packed frame. ``demo_case`` builds that
scene, and its glass variant with translucent instances, at any size,
and ``world_case`` the archive world with its animated characters, so
scripts reach both through the port alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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
