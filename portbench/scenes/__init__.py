"""Scene builders: a configuration's host arrays, made from ``--seed``.

Each builder (``portbench/scenes/<builder>.py``, named by a
configuration's ``"builder"`` key) exposes ``build(cfg, seed) ->
SceneArrays``. The arrays are handed to the program (as its
``DrawBatch``) and to the plain reference alike; nothing here imports
the program.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent


@dataclass
class SceneArrays:
    """One scene as plain arrays (indexed triangle soup)."""

    positions: np.ndarray        # (V, 3) f32
    uvs: np.ndarray              # (V, 2) f32
    joints: np.ndarray           # (V, W) i32 palette indices
    weights: np.ndarray          # (V, W) f32; all zero = not skinned
    tris: np.ndarray             # (T, 3) i32, counter-clockwise outward
    tri_texture: np.ndarray      # (T,) i32 texture id (every triangle textured)
    tri_material: np.ndarray     # (T,) i32 material slot
    mat_color: np.ndarray        # (M, 4) f32 0-1 multipliers
    textures: list               # (h, w, 4) u8 each, mip 0
    num_joints: int
    # the animation the palette follows (see reference.palette)
    animation: dict = field(default_factory=dict)
    # extra arrays a builder keeps for the program's own animator
    extra: dict = field(default_factory=dict)
    # an asset's compressed mip chains, or None: per texture its levels
    # as (blocks (nb, k) u8, h, w) down to 1x1, nb = ceil(h/4) ceil(w/4);
    # ``textures`` then holds each chain's level 0, decoded
    chains: list | None = None
    chain_format: str | None = None   # "bc1" (k = 8) or "bc7" (k = 16)

    @property
    def num_triangles(self) -> int:
        return len(self.tris)


def builder(name: str, root: Path | None = None):
    """The builder module ``<root>/scenes/<name>.py``, ``root`` being
    this package's folder or a copy of it with files of its own; its
    relative imports resolve in this package."""
    path = Path(root or _HERE.parent) / "scenes" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.scenes.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def strip_tris(index: np.ndarray, restart: int = 0xFFFF) -> np.ndarray:
    """A triangle strip with restarts → (T, 3) i32, every odd triangle's
    first two corners swapped (winding kept), degenerates dropped."""
    idx = np.asarray(index, np.int64)
    out, start = [], 0
    for stop in list(np.flatnonzero(idx == restart)) + [len(idx)]:
        run = idx[start:stop]
        start = stop + 1
        if len(run) < 3:
            continue
        a, b, c = run[:-2], run[1:-1], run[2:]
        odd = (np.arange(len(a)) % 2).astype(bool)
        t = np.stack([np.where(odd, b, a), np.where(odd, a, b), c], -1)
        keep = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
        out.append(t[keep])
    return np.concatenate(out).astype(np.int32)


def subdivided_cube(n: int):
    """Unit cube, each face an n x n grid as one strip a row →
    (positions (V, 3) f32, uvs (V, 2) f32, tris (12 n^2, 3) i32),
    counter-clockwise seen from outside."""
    verts, uvs, index = [], [], []
    axes = np.eye(3, dtype=np.float32)
    for axis in range(3):
        for sign in (1.0, -1.0):
            normal = axes[axis] * sign
            udir, vdir = axes[(axis + 1) % 3], axes[(axis + 2) % 3]
            if np.dot(np.cross(vdir, udir), normal) < 0:
                udir, vdir = vdir, udir
            base = len(verts)
            for vi in range(n + 1):
                for ui in range(n + 1):
                    verts.append(normal + udir * (2.0 * ui / n - 1.0)
                                 + vdir * (2.0 * vi / n - 1.0))
                    uvs.append([ui / n, vi / n])
            for vi in range(n):
                if index:
                    index.append(0xFFFF)
                for ui in range(n + 1):
                    index += [base + vi * (n + 1) + ui,
                              base + (vi + 1) * (n + 1) + ui]
    return (np.array(verts, np.float32), np.array(uvs, np.float32),
            strip_tris(np.array(index)))


def corner_cube():
    """The 8-corner cube as two strips → (positions (8, 3), uvs (8, 2),
    tris (12, 3))."""
    corners = np.array([[-1, -1, -1], [1, -1, -1], [-1, 1, -1], [1, 1, -1],
                        [-1, -1, 1], [1, -1, 1], [-1, 1, 1], [1, 1, 1]],
                       np.float32)
    uvs = (corners[:, :2] * 0.5 + 0.5).astype(np.float32)
    index = [0, 1, 4, 5, 6, 7, 2, 3, 0, 1, 0xFFFF, 1, 3, 5, 7, 0xFFFF,
             2, 0, 6, 4]
    return corners, uvs, strip_tris(np.array(index))


def pattern(size: int, rng) -> np.ndarray:
    """A (size, size, 4) u8 opaque test texture drawn from ``rng``: a
    checker, stripes, rings or diagonal blocks in two colors, with a
    little per-texel noise so that every mip level differs."""
    kind = int(rng.integers(0, 4))
    yy, xx = np.mgrid[0:size, 0:size]
    c0 = rng.integers(40, 255, 3)
    c1 = rng.integers(40, 255, 3)
    cells = int(rng.choice([2, 4, 8]))
    if kind == 0:
        mask = ((xx * cells // size) + (yy * cells // size)) % 2 == 0
    elif kind == 1:
        mask = (xx * cells // size) % 2 == 0
    elif kind == 2:
        mask = (np.hypot(xx - size / 2, yy - size / 2) * 2 * cells
                / size).astype(int) % 2 == 0
    else:
        mask = ((xx + yy) * cells // (2 * size)) % 2 == 0
    img = np.where(mask[..., None], c0, c1) + rng.integers(
        -12, 13, (size, size, 3))
    return np.concatenate([np.clip(img, 0, 255).astype(np.uint8),
                           np.full((size, size, 1), 255, np.uint8)], -1)
