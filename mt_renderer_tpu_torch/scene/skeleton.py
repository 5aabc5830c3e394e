"""Skeleton pose math — forward kinematics + skinning palettes.

The reference parses joints, local matrices and inverse-bind matrices
(``src/rmodel.rs:372-422``) and only visualises joint
positions (model.rs:309-315); posing is not implemented there. Here the
skeleton is a first-class animated object: local transforms (rest pose ×
animated deltas) compose through the parent chain and multiply the
inverse-bind matrices into the bone palette consumed by the skinning
matmul (``render/device.py`` vertex stage).

All matrices are float32 (4, 4) acting on column vectors. MT orders
joints parent-before-child (validated at load), so FK is a single
in-order pass. ``pose`` runs it in NumPy on the host; ``pose_device``
runs it in torch on the deltas' device, every 4x4 product written out
as elementwise f32 ops in one fixed order (``mat4_mul``): no matmul, so
no TF32 and no library's summation order, and the CPU and the card give
the same bits.
"""

from __future__ import annotations

import numpy as np
import torch


def mat4_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 4, 4) @ (..., 4, 4) (broadcasting) as elementwise
    f32 ops: out[i, k] = ((a[i,0] b[0,k] + a[i,1] b[1,k]) + a[i,2] b[2,k])
    + a[i,3] b[3,k], each product and sum rounded on its own."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for j in range(1, 4):
        out = out + a[..., :, j:j + 1] * b[..., j:j + 1, :]
    return out


class Skeleton:
    """Static skeleton data: parents, rest-pose locals, inverse binds."""

    def __init__(self, parents: np.ndarray, local_mats: np.ndarray,
                 inverse_bind_mats: np.ndarray):
        self.parents = np.asarray(parents, np.int32)
        self.local_mats = np.asarray(local_mats, np.float32)
        self.inverse_bind_mats = np.asarray(inverse_bind_mats, np.float32)
        if not (self.parents < np.arange(len(self.parents))).all():
            raise ValueError("joints must be ordered parent-before-child")

    @classmethod
    def from_model(cls, model) -> "Skeleton | None":
        """Build from a parsed ModelFile (None when unskinned)."""
        if not model.joints:
            return None
        parents = np.array(
            [j.parent if j.parent != 255 else -1 for j in model.joints],
            np.int32,
        )
        return cls(parents, model.local_mats, model.inverse_bind_mats)

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    def pose(self, deltas: np.ndarray | None = None) -> np.ndarray:
        """Host FK: palette (J, 4, 4) = world ∘ inverse_bind.

        ``deltas``: optional per-joint (J, 4, 4) animated local transforms
        applied after the rest local (local @ delta)."""
        j = self.num_joints
        world = np.empty((j, 4, 4), np.float32)
        for i in range(j):
            local = self.local_mats[i]
            if deltas is not None:
                local = local @ deltas[i]
            p = self.parents[i]
            world[i] = local if p < 0 else world[p] @ local
        return np.einsum("jik,jkl->jil", world, self.inverse_bind_mats)

    def pose_device(self, deltas: torch.Tensor) -> torch.Tensor:
        """FK over the parent chain in torch on ``deltas``' device:
        (J, 4, 4) f32 deltas → palette (J, 4, 4) = world ∘ inverse_bind,
        world_i = world_parent(i) @ (local_i @ delta_i)."""
        dev = deltas.device
        locals_ = mat4_mul(torch.as_tensor(self.local_mats, device=dev),
                           deltas.to(torch.float32))
        world = []
        for i in range(self.num_joints):
            p = int(self.parents[i])
            world.append(locals_[i] if p < 0
                         else mat4_mul(world[p], locals_[i]))
        return mat4_mul(torch.stack(world),
                        torch.as_tensor(self.inverse_bind_mats, device=dev))

    def joint_world_positions(self, deltas: np.ndarray | None = None
                              ) -> np.ndarray:
        """World-space joint origins (for the debug overlay feed)."""
        j = self.num_joints
        world = np.empty((j, 4, 4), np.float32)
        for i in range(j):
            local = self.local_mats[i]
            if deltas is not None:
                local = local @ deltas[i]
            p = self.parents[i]
            world[i] = local if p < 0 else world[p] @ local
        return world[:, :3, 3].copy()


def euler_translation_mats(rx, ry, rz, tx, ty, tz) -> np.ndarray:
    """Per-joint local delta: T(t) · Rz · Ry · Rx, vectorised over (J,)."""
    rx, ry, rz = (np.asarray(a, np.float32) for a in (rx, ry, rz))
    tx, ty, tz = (np.asarray(a, np.float32) for a in (tx, ty, tz))
    j = len(rx)
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    m = np.zeros((j, 4, 4), np.float32)
    m[:, 0, 0] = cz * cy
    m[:, 0, 1] = cz * sy * sx - sz * cx
    m[:, 0, 2] = cz * sy * cx + sz * sx
    m[:, 1, 0] = sz * cy
    m[:, 1, 1] = sz * sy * sx + cz * cx
    m[:, 1, 2] = sz * sy * cx - cz * sx
    m[:, 2, 0] = -sy
    m[:, 2, 1] = cy * sx
    m[:, 2, 2] = cy * cx
    m[:, 0, 3] = tx
    m[:, 1, 3] = ty
    m[:, 2, 3] = tz
    m[:, 3, 3] = 1.0
    return m
