"""The skinned demo scene: ``instances`` subdivided cubes on a square
grid, each skinned to a two-bone palette (corners with z > 0 follow bone
1, the rest bone 0), one texture, one material slot.

A frozen copy of the shapes of the program's demo scene (the bench's
headline): the same grid, cube and skin. The texture's content is drawn
from the seed; every size is the configuration's.
"""

from __future__ import annotations

import numpy as np

from . import SceneArrays, pattern, subdivided_cube


def grid_offsets(instances: int, spacing: float) -> np.ndarray:
    side = int(np.ceil(np.sqrt(instances)))
    i = np.arange(instances)
    gx = (i % side).astype(np.float32) - (side - 1) / 2.0
    gy = (i // side).astype(np.float32) - (side - 1) / 2.0
    return np.stack([gx, gy, np.zeros_like(gx)], 1) * np.float32(spacing)


def build(cfg: dict, seed: int) -> SceneArrays:
    rng = np.random.default_rng(seed)
    pos, uv, tris = subdivided_cube(cfg["subdiv"])
    v = len(pos)
    n = cfg["instances"]
    off = grid_offsets(n, cfg["spacing"])
    bone = (pos[:, 2] > 0).astype(np.int32)
    joints = np.zeros((v, 4), np.int32)
    joints[:, 0] = bone
    weights = np.zeros((v, 4), np.float32)
    weights[:, 0] = 1.0
    t = len(tris) * n
    return SceneArrays(
        positions=(pos[None] + off[:, None]).reshape(-1, 3).astype(np.float32),
        uvs=np.tile(uv, (n, 1)),
        joints=np.tile(joints, (n, 1)),
        weights=np.tile(weights, (n, 1)),
        tris=(tris[None] + (np.arange(n, dtype=np.int32) * v)[:, None, None]
              ).reshape(-1, 3).astype(np.int32),
        tri_texture=np.zeros(t, np.int32),
        tri_material=np.zeros(t, np.int32),
        mat_color=np.ones((1, 4), np.float32),
        textures=[pattern(cfg["texture_size"], rng)],
        num_joints=2,
        animation=dict(cfg["animation"]),
    )
