"""Vertex decode and triangle-strip expansion (host, NumPy).

The engine stores vertices as raw packed bytes; each primitive names an
rShader2 INPUTLAYOUT whose elements give (format, count, offset) per
attribute (reference ``rshader2.rs:496-571`` maps these to wgpu vertex
formats; here they decode to float arrays once at load).

Index semantics follow the reference draw call
(``model.rs:335-361``): the vertex slice starts at ``vertex_base`` bytes
into the model vertex pool; indices come from
``index_buf[index_ofs : index_ofs+index_num]`` with ``index_base`` added,
interpreted as a triangle strip with 0xffff restart.
"""

from __future__ import annotations

import numpy as np

from ..formats.mfx import InputElement, InputElementFormat as F
from ..formats.mod import STRIP_RESTART


def decode_element(raw: np.ndarray, elem: InputElement) -> np.ndarray:
    """Decode one attribute from (N, stride) raw bytes → (N, count) float32
    (or int32 for integer formats like Joint indices)."""
    n = raw.shape[0]
    o = elem.offset
    c = elem.count

    def view(dt, width):
        return (
            raw[:, o:o + c * width]
            .copy()
            .view(dt)
            .reshape(n, c)
        )

    f = elem.format
    if f == F.IEF_F32:
        return view("<f4", 4).astype(np.float32)
    if f == F.IEF_F16:
        return view("<f2", 2).astype(np.float32)
    if f == F.IEF_S16:
        return view("<i2", 2).astype(np.int32)
    if f == F.IEF_U16:
        return view("<u2", 2).astype(np.int32)
    if f == F.IEF_S16N:
        v = view("<i2", 2).astype(np.float32) / 32767.0
        return np.maximum(v, -1.0)
    if f == F.IEF_U16N:
        return view("<u2", 2).astype(np.float32) / 65535.0
    if f == F.IEF_S8:
        return view("i1", 1).astype(np.int32)
    if f == F.IEF_U8:
        return view("u1", 1).astype(np.int32)
    if f == F.IEF_S8N:
        v = view("i1", 1).astype(np.float32) / 127.0
        return np.maximum(v, -1.0)
    if f in (F.IEF_U8N, F.IEF_U8NL, F.IEF_COLOR4N):
        return view("u1", 1).astype(np.float32) / 255.0
    if f in (F.IEF_SCMP3N, F.IEF_UCMP3N):
        # 10:10:10:2-packed compressed normal; the reference skips SCMP3N
        # attributes entirely (rshader2.rs:517-520) — decode the xyz here.
        packed = raw[:, o:o + 4].copy().view("<u4").reshape(n)
        xyz = np.stack([
            (packed >> 0) & 0x3FF, (packed >> 10) & 0x3FF, (packed >> 20) & 0x3FF,
        ], axis=-1).astype(np.int32)
        if f == F.IEF_SCMP3N:
            xyz = np.where(xyz >= 512, xyz - 1024, xyz).astype(np.float32) / 511.0
            return np.maximum(xyz, -1.0)
        return xyz.astype(np.float32) / 1023.0
    raise NotImplementedError(f"vertex element format {f!r}")


def decode_vertices(vertex_buf: np.ndarray, vertex_base: int, stride: int,
                    count: int, elements: list[InputElement]) -> dict[str, np.ndarray]:
    """Decode ``count`` vertices starting at byte ``vertex_base``.

    Returns attribute name → array. Duplicate semantic names (secondary
    streams — MT layouts carry multiple Joint/Weight elements with a
    stream index, rshader2.rs:425-450) are suffixed by occurrence:
    "Joint", "Joint1", "Joint2"… in element order. Use
    ``gather_streams`` to re-concatenate them.
    """
    raw = vertex_buf[vertex_base:vertex_base + count * stride]
    raw = np.asarray(raw, dtype=np.uint8).reshape(count, stride)
    out: dict[str, np.ndarray] = {}
    seen: dict[str, int] = {}
    for elem in elements:
        k = seen.get(elem.name, 0)
        seen[elem.name] = k + 1
        key = elem.name if k == 0 else f"{elem.name}{k}"
        out[key] = decode_element(raw, elem)
    return out


def gather_streams(attrs: dict[str, np.ndarray], base: str) -> np.ndarray | None:
    """Concatenate an attribute's streams ("Joint" + "Joint1" + …) into
    one (N, total) array; None when the attribute is absent."""
    parts = []
    k = 0
    while True:
        key = base if k == 0 else f"{base}{k}"
        if key not in attrs:
            break
        parts.append(attrs[key])
        k += 1
    if not parts:
        return None
    return np.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]


def strip_to_triangles(indices: np.ndarray, index_base: int = 0) -> np.ndarray:
    """Expand a u16 triangle strip (with 0xffff restart) to (T, 3) int32.

    Preserves winding: every odd triangle in a strip swaps its first two
    vertices. Degenerate triangles (repeated indices) are dropped — GPUs
    skip them at setup, and strips use them for stitching.
    """
    idx = np.asarray(indices, dtype=np.int64)
    tris = []
    start = 0
    restarts = np.flatnonzero(idx == STRIP_RESTART).tolist() + [len(idx)]
    for stop in restarts:
        run = idx[start:stop]
        start = stop + 1
        if len(run) < 3:
            continue
        a = run[:-2]
        b = run[1:-1]
        c = run[2:]
        odd = (np.arange(len(a)) % 2).astype(bool)
        t = np.stack([np.where(odd, b, a), np.where(odd, a, b), c], axis=-1)
        good = (t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])
        tris.append(t[good])
    if not tris:
        return np.zeros((0, 3), dtype=np.int32)
    return (np.concatenate(tris) + index_base).astype(np.int32)
