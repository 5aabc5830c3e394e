"""Debug overlay — instanced unit cubes for joint visualisation.

The analog of the reference's instanced cube pass
(``src/debug_overlay.rs``): per frame, apps push cube
transforms (``add_cube``/``clear``, debug_overlay.rs:223-243); here they
become a flat-colored DrawBatch merged into the frame's triangle set
(constant color (0.1, 0.2, 0.3, 1.0), no blend, depth-tested —
debug_overlay.wgsl fragment + its pipeline state). The reference caps at
1024 instances with a ``todo!`` on overflow; this keeps the cap and
raises cleanly.
"""

from __future__ import annotations

import numpy as np

from .model import DrawBatch

MAX_INSTANCES = 1024
OVERLAY_RGBA = np.array([0.1 * 255, 0.2 * 255, 0.3 * 255, 255.0], np.float32)

# unit cube centered at origin: 8 corners, 12 triangles (CCW outward)
_CORNERS = np.array([
    [-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1],
], np.float32) * 0.5
_TRIS = np.array([
    [0, 2, 1], [1, 2, 3],      # -z
    [4, 5, 6], [5, 7, 6],      # +z
    [0, 1, 4], [1, 5, 4],      # -y
    [2, 6, 3], [3, 6, 7],      # +y
    [0, 4, 2], [2, 4, 6],      # -x
    [1, 3, 5], [3, 7, 5],      # +x
], np.int32)


class DebugOverlay:
    def __init__(self):
        self._mats: list[np.ndarray] = []

    def add_cube(self, transform: np.ndarray) -> None:
        """Queue one cube with a 4x4 world transform."""
        if len(self._mats) >= MAX_INSTANCES:
            raise ValueError(f"debug overlay capped at {MAX_INSTANCES} cubes")
        self._mats.append(np.asarray(transform, np.float32))

    def add_cube_at(self, position, scale: float = 0.05) -> None:
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = m[2, 2] = scale
        m[:3, 3] = position
        self.add_cube(m)

    def clear(self) -> None:
        self._mats.clear()

    @property
    def num_instances(self) -> int:
        return len(self._mats)

    def batch(self) -> DrawBatch | None:
        """The queued cubes as a flat-colored DrawBatch (None if empty)."""
        if not self._mats:
            return None
        mats = np.stack(self._mats)                       # (N, 4, 4)
        homo = np.concatenate(
            [_CORNERS, np.ones((8, 1), np.float32)], axis=1
        )
        pos = np.einsum("nij,vj->nvi", mats, homo)[..., :3]
        n = len(mats)
        v = pos.reshape(-1, 3).astype(np.float32)
        tris = (_TRIS[None] + (np.arange(n)[:, None, None] * 8)).reshape(-1, 3)
        t = len(tris)
        return DrawBatch(
            positions=v,
            uvs=np.zeros((len(v), 2), np.float32),
            joints=np.zeros((len(v), 4), np.int32),
            weights=np.zeros((len(v), 4), np.float32),
            tris=tris.astype(np.int32),
            tri_texture=np.full(t, -1, np.int32),
            tri_parts=np.zeros(t, np.int32),
            tri_debug_id=np.zeros(t, np.int32),
            tri_flat=np.tile(OVERLAY_RGBA, (t, 1)),
        )
