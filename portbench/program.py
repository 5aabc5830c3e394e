"""The system under test: ``mt_renderer_tpu_torch``, driven as its users
drive it. Everything the benchmark takes from the program goes through
here: the scene handed over as a ``DrawBatch`` and ``device.upload``,
the viewer's ``FrameEngine`` loop, the served artifact, the program's
own palette, and its overflow counters.
"""

from __future__ import annotations

import numpy as np


def draw_batch(arrays):
    """The scene arrays as the program's host ``DrawBatch``."""
    from mt_renderer_tpu_torch.scene.model import DrawBatch

    t = arrays.num_triangles
    slots = len(arrays.mat_color)
    batch = DrawBatch(
        positions=arrays.positions, uvs=arrays.uvs, joints=arrays.joints,
        weights=arrays.weights, tris=arrays.tris,
        tri_texture=arrays.tri_texture,
        tri_parts=np.zeros(t, np.int32), tri_debug_id=np.zeros(t, np.int32),
        tri_material=arrays.tri_material, textures=list(arrays.textures),
        material_names=[f"slot{i}" for i in range(slots)],
        inverse_bind_mats=np.tile(np.eye(4, dtype=np.float32),
                                  (arrays.num_joints, 1, 1)),
        joint_parents=np.full(arrays.num_joints, -1, np.int32),
        joint_offsets=np.zeros((arrays.num_joints, 3), np.float32),
        skinned=True)
    batch.mat_color_host = arrays.mat_color
    return batch


class ProgramPalette:
    """The palette as the program computes it for a viewer: the demo's
    two-bone palette on the host (``scene.demo.demo_bone_mats``), or the
    world's timeline posed on the device (``BoneAnimator.
    bone_mats_device`` and ``WorldScene.bone_palette``, as the world
    viewer does)."""

    def __init__(self, arrays, device):
        anim = arrays.animation
        self.anim = anim
        self.device = device
        if anim["kind"] == "two_bone":
            from mt_renderer_tpu_torch.scene import demo

            self._demo = demo
            return
        from mt_renderer_tpu_torch.dti import PropType
        from mt_renderer_tpu_torch.formats import sdl
        from mt_renderer_tpu_torch.scene.animation import BoneAnimator, Timeline
        from mt_renderer_tpu_torch.scene.skeleton import Skeleton
        from mt_renderer_tpu_torch.scene.world import WorldScene

        tracks = [sdl.Track(sdl.TrackType.TYPE_ROOT, 0, "root", 0)]
        for name, keys in anim["tracks"].items():
            tracks.append(sdl.Track(
                sdl.TrackType.TYPE_FLOAT, int(PropType.f32), name, 0,
                keys=[sdl.Key(int(f), 1, float(v)) for f, v in keys]))
        timeline = Timeline(sdl.SchedulerFile(sdl.write_scheduler(tracks)))
        nj = len(anim["parents"])
        eye = np.tile(np.eye(4, dtype=np.float32), (nj, 1, 1))
        skeleton = Skeleton(np.asarray(anim["parents"], np.int32), eye, eye)
        self._animator = BoneAnimator(timeline, skeleton)
        self._world = WorldScene(None, None, np.asarray(
            anim["characters"], np.float32), skeleton, timeline, {})

    def __call__(self, t: float):
        anim = self.anim
        if anim["kind"] == "two_bone":
            return self._demo.demo_bone_mats(t * anim["phase_per_s"])
        frame = np.float32((t * anim["fps"]) % anim["duration"])
        return self._world.bone_palette(
            self._animator.bone_mats_device(frame, self.device))


def upload(arrays, cfg: dict, device):
    """(host batch, the scene on ``device``). A compressed pool takes the
    builder's chains as a viewer takes a ``.tex`` asset's
    (``bc1_chains=`` or ``bc7_chains=``), so the program's own encoder
    never runs in a cell: a ``bc1`` or ``bc7`` pool without chains of its
    format, or chains under another pool, raises ``ValueError``."""
    from mt_renderer_tpu_torch.render import device as dv

    pool, fmt = cfg["pool"], arrays.chain_format
    if arrays.chains is None and pool in ("bc1", "bc7"):
        raise ValueError(f"a {pool} pool needs the builder's {pool} "
                         "chains; the scene arrays have none")
    if arrays.chains is not None and fmt != pool:
        raise ValueError(f"{fmt} chains need pool {fmt!r}, not {pool!r}")
    chains = {} if arrays.chains is None else {
        f"{pool}_chains": arrays.chains}
    batch = draw_batch(arrays)
    return batch, dv.upload(batch, pool, device=device,
                            mipmap=cfg["mipmap"], **chains)


def frame_engine(scene, batch, cfg: dict):
    """The viewer's engine: ``interactive``, one overflow flush a frame."""
    from mt_renderer_tpu_torch.render.engine import FrameEngine

    return FrameEngine(scene, batch, width=cfg["width"],
                       height=cfg["height"], mipmap=cfg["mipmap"],
                       lighting=cfg["lighting"], interactive=True)


def served_artifact(scene, cfg: dict):
    """Export the render step for this scene, serialise it and load it
    back, as a serving host does → (the loaded artifact, its bytes)."""
    from mt_renderer_tpu_torch import serving

    blob = serving.export_render(scene, width=cfg["width"],
                                 height=cfg["height"], mipmap=cfg["mipmap"])
    return serving.load_render(blob), len(blob)


def flush_overflow() -> int:
    """Drain the program's deferred overflow queue → overflowed
    tile-frames counted since the last drain."""
    from mt_renderer_tpu_torch.render import raster

    return sum(n for n, _ in raster.flush_overflow_counts().values())


def packed_rgba(color, height: int, width: int) -> np.ndarray:
    """A frame on the host as (H, W, 4) u8 RGBA: the packed (H, W) int32
    frame's bytes, or an (H, W, 4) u8 frame as it is."""
    a = np.ascontiguousarray(color)
    return a.view(np.uint8).reshape(height, width, 4)
