"""Demo scene builders — in-memory fixture scenes at arbitrary scale.

The flagship workload (graft entry + bench) is the BASELINE.json north
star: a textured + skinned rModel scene. No game assets ship with the
repo, so the scene is built from the synthetic fixture assets: N instanced
cubes in a grid, parsed through the *full* asset path (rShader2 → rModel →
rMaterial → rTexture → DrawBatch), then instanced by baking grid offsets
into the pooled vertices.
"""

from __future__ import annotations

import numpy as np

from .. import dti as dti_mod
from .. import fixtures
from ..formats.mfx import Shader2File
from ..formats.mod import ModelFile
from ..formats.mrl import MaterialFile
from ..resources.memory import MemoryResourceManager
from .model import DrawBatch, build_draw_batch


def replicate_batch(batch: DrawBatch, offsets: np.ndarray) -> DrawBatch:
    """Instance a batch at ``offsets`` (N, 3) by baking translated copies
    into one larger batch (bones are shared across instances)."""
    n = len(offsets)
    v = batch.num_vertices
    pos = (batch.positions[None] + offsets[:, None, :].astype(np.float32))
    tris = (batch.tris[None] + (np.arange(n, dtype=np.int32) * v)[:, None, None])
    return DrawBatch(
        positions=pos.reshape(-1, 3),
        uvs=np.tile(batch.uvs, (n, 1)),
        joints=np.tile(batch.joints, (n, 1)),
        weights=np.tile(batch.weights, (n, 1)),
        tris=tris.reshape(-1, 3),
        tri_texture=np.tile(batch.tri_texture, n),
        tri_parts=np.tile(batch.tri_parts, n),
        tri_debug_id=np.tile(batch.tri_debug_id, n),
        textures=batch.textures,
        inverse_bind_mats=batch.inverse_bind_mats,
        joint_parents=batch.joint_parents,
        joint_offsets=batch.joint_offsets,
        skinned=batch.skinned,
    )


def grid_offsets(instances: int, spacing: float = 3.0) -> np.ndarray:
    """Centered square-ish XY grid of ``instances`` offsets."""
    side = int(np.ceil(np.sqrt(instances)))
    ii = np.arange(instances)
    gx = (ii % side).astype(np.float32)
    gy = (ii // side).astype(np.float32)
    off = np.stack(
        [gx - (side - 1) / 2.0, gy - (side - 1) / 2.0, np.zeros_like(gx)], 1
    )
    return off * spacing


def build_demo_batch(instances: int = 1, skinned: bool = True,
                     texture_size: int = 64, subdiv: int = 0) -> DrawBatch:
    """Parse the fixture assets fully in-memory and instance them.

    ``subdiv`` > 0 uses the n×n-per-face cube (12n² tris per instance)."""
    rm = MemoryResourceManager()
    d = dti_mod.from_name
    rm.put(fixtures.TEXTURE_PATH, d("rTexture"),
           fixtures.build_texture_rgba(texture_size))
    shader2 = Shader2File(fixtures.build_shader2())
    model = ModelFile(fixtures.build_model(skinned=skinned, subdiv=subdiv))
    material = MaterialFile(fixtures.build_material(), shader2)
    batch = build_draw_batch(model, material, shader2, rm)
    if instances > 1:
        batch = replicate_batch(batch, grid_offsets(instances))
    return batch


def make_translucent(batch: DrawBatch, instances: int,
                     fraction: float = 0.25,
                     alpha: float = 0.5) -> DrawBatch:
    """Make ~``fraction`` of the instances translucent: assigns them
    material slot 1 whose color multiplier has alpha < 1 (the same
    animatable ``mat_color`` channel rScheduler tracks drive), so the
    OIT paths see real mixed opaque/translucent content — the
    ``--preset glass`` workload."""
    t = batch.num_triangles
    per = max(t // max(instances, 1), 1)
    inst = np.arange(t, dtype=np.int64) // per
    k = max(int(round(1.0 / fraction)), 1)
    batch.tri_material = np.where(inst % k == 0, 1, 0).astype(np.int32)
    batch.mat_color_host = np.array(
        [[1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, alpha]], np.float32)
    return batch


def demo_camera(instances: int = 1, width: int = 512, height: int = 512):
    """A camera that frames the demo grid."""
    from ..app.camera import Camera

    side = int(np.ceil(np.sqrt(instances)))
    dist = max(4.0, side * 3.2)
    cam = Camera(
        position=[0.0, 0.0, dist], yaw=15.0, pitch=-20.0,
        far=max(50.0, dist * 4.0),
    )
    cam.aspect = width / height
    return cam


def demo_bone_mats(t: float = 0.0) -> np.ndarray:
    """Two-bone palette animated by phase ``t`` (bone 1 swings in x)."""
    m = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    m[1, 0, 3] = 0.5 * np.sin(t)
    return m
