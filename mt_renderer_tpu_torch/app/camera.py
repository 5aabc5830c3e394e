"""Fly camera — same math as the reference (``src/camera.rs``).

``view = inverse(T · R_yaw · R_pitch)`` (camera.rs:30-38);
``proj = perspective_rh(fov°, aspect, 0.01, 50.0)`` with [0,1] depth
(camera.rs:40-43); mouse look with sensitivity 0.1 and pitch clamped to
±89° (camera.rs:49-59), and WASD flight along the camera basis.

Matrices are float32 (4,4) acting on column vectors: ``clip = P @ V @ p``.
"""

from __future__ import annotations

import numpy as np

SENSITIVITY = 0.1
NEAR = 0.01
FAR = 50.0


def rotation_y(deg: float) -> np.ndarray:
    r = np.radians(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([
        [c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1],
    ], dtype=np.float32)


def rotation_x(deg: float) -> np.ndarray:
    r = np.radians(deg)
    c, s = np.cos(r), np.sin(r)
    return np.array([
        [1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1],
    ], dtype=np.float32)


def translation(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def perspective_rh(fov_deg: float, aspect: float,
                   near: float = NEAR, far: float = FAR) -> np.ndarray:
    """Right-handed perspective with [0, 1] clip depth (wgpu convention)."""
    f = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m


class Camera:
    def __init__(self, position, yaw: float = 0.0, pitch: float = 0.0,
                 fov: float = 50.0, near: float = NEAR, far: float = FAR):
        self.position = np.asarray(position, dtype=np.float32)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.fov = float(fov)
        self.aspect = 1.0
        self.near = float(near)
        self.far = float(far)

    def view(self) -> np.ndarray:
        m = translation(self.position) @ rotation_y(self.yaw) @ rotation_x(self.pitch)
        return np.linalg.inv(m).astype(np.float32)

    def proj(self) -> np.ndarray:
        return perspective_rh(self.fov, self.aspect, self.near, self.far)

    def view_proj(self) -> np.ndarray:
        return (self.proj() @ self.view()).astype(np.float32)

    def update(self, input_state, aspect: float) -> None:
        dx, dy = input_state.frame_mouse_delta
        self.yaw = (self.yaw - SENSITIVITY * dx) % 360.0
        self.pitch = float(np.clip(self.pitch - SENSITIVITY * dy, -89.0, 89.0))
        self.aspect = float(aspect)

    def fly(self, input_state, dt: float, speed: float = 2.0) -> None:
        """WASD translation along the camera basis.

        Extension: the reference *tracks* WASD (input_state.rs:3-11,
        renderer_app_manager.rs:229-255) but no app ever consumes the
        keys — this makes the fly camera actually fly. W/S move along
        the view direction, A/D strafe; ``speed`` is units/second."""
        from .input_state import Key

        r = rotation_y(self.yaw) @ rotation_x(self.pitch)
        fwd = -r[:3, 2]
        right = r[:3, 0]
        d = np.zeros(3, np.float32)
        if input_state.has_key(Key.W):
            d += fwd
        if input_state.has_key(Key.S):
            d -= fwd
        if input_state.has_key(Key.D):
            d += right
        if input_state.has_key(Key.A):
            d -= right
        self.position = (self.position + d * (speed * dt)).astype(np.float32)
