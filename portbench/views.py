"""Views: the configuration's camera, orbited about the scene's z axis.

``clip = P V R_z(yaw) p``: ``P`` a right-handed perspective with [0, 1]
depth, ``V`` the inverse of the camera's T R_y(yaw0) R_x(pitch), and
``R_z`` turns the scene about its vertical axis (both scenes stand on
the xy plane), as a viewer's orbit drag does. Matrices are f32 (4, 4)
on column vectors.
"""

from __future__ import annotations

import math

import numpy as np


def _rot(axis: int, deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.eye(4)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def perspective(fov_deg: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    f = 1.0 / math.tan(math.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


def view_proj(cam: dict, width: int, height: int, yaw: float) -> np.ndarray:
    """The camera ``cam`` (position, yaw, pitch, fov, near, far) with the
    scene turned ``yaw`` degrees about z → (4, 4) f32."""
    t = np.eye(4)
    t[:3, 3] = cam["position"]
    view = np.linalg.inv(t @ _rot(1, cam["yaw"]) @ _rot(0, cam["pitch"]))
    proj = perspective(cam["fov"], width / height, cam["near"], cam["far"])
    return (proj @ view @ _rot(2, yaw)).astype(np.float32)
