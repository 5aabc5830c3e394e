"""CPU reference rasterizer (NumPy) — the correctness oracle.

Implements exactly the pipeline the device path must match, pixel for pixel:

* clip = ``view_proj @ [p, 1]`` (column vectors, [0,1] depth),
* whole-triangle near rejection (any vertex with ``w <= eps`` is culled —
  both paths share this rule instead of polygon clipping),
* viewport: ``px = (x/w + 1)/2 * W``, ``py = (1 - (y/w + 1)/2) * H``,
  samples at pixel centers,
* back-face culling of clockwise triangles in y-down screen space
  (wgpu front face = CCW, cull back — model.rs:242-249 defaults),
* edge-function coverage with a top-left fill rule,
* screen-linear depth (``z/w``) with LessEqual test against a 1.0-cleared
  buffer (model.rs:255-261),
* perspective-correct attribute interpolation,
* bilinear clamp-to-edge albedo sampling (texture.rs:33-42: mag Linear),
* src-alpha / one-minus-src-alpha blending (model.rs:242-247),
* untextured triangles shade with the 20-color debug-id palette
  (shaders/debug_ids.wgsl).

Clarity over speed: this renders triangle by triangle with vectorised
pixels, and exists to differential-test the jnp/Pallas renderers.
"""

from __future__ import annotations

import numpy as np

from ..scene.model import DEBUG_PALETTE, DrawBatch

W_EPS = 1e-6


def skin_positions(batch: DrawBatch, bone_mats: np.ndarray | None) -> np.ndarray:
    """Apply bone-palette skinning on host. ``bone_mats``: (J, 4, 4) final
    matrices (already multiplied by inverse bind)."""
    pos = batch.positions
    if not batch.skinned or bone_mats is None:
        return pos
    homo = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
    m = bone_mats[batch.joints]                # (V, 4, 4, 4)
    skinned = np.einsum("vwij,vj->vwi", m, homo)  # (V, 4, 4)
    blended = (skinned * batch.weights[..., None]).sum(axis=1)
    # zero-weight vertices (merged unskinned geometry, e.g. overlay cubes)
    # pass through untransformed
    has_w = batch.weights.sum(axis=1, keepdims=True) > 0
    return np.where(has_w, blended[:, :3], pos).astype(np.float32)


def sample_bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear clamp-to-edge sample; uv in [0,1], v down. Returns float 0-255."""
    h, w = tex.shape[:2]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    t = tex.astype(np.float32)
    c00 = t[y0c, x0c]
    c10 = t[y0c, x1c]
    c01 = t[y1c, x0c]
    c11 = t[y1c, x1c]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def render(
    batch: DrawBatch,
    view_proj: np.ndarray,
    width: int,
    height: int,
    bone_mats: np.ndarray | None = None,
    clear_color=(255, 255, 255, 255),
    extra_tris: tuple | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Render to ((H, W, 4) uint8, (H, W) float32 depth).

    ``extra_tris``: optional overlay geometry appended after the model —
    (positions (V,3), tris (T,3), color rgba float 0-1) drawn with no blend
    (debug_overlay.rs pipeline: no blend, depth LEq).
    """
    color = np.empty((height, width, 4), dtype=np.float32)
    color[:] = np.asarray(clear_color, dtype=np.float32)
    depth = np.full((height, width), 1.0, dtype=np.float32)

    pos = skin_positions(batch, bone_mats)
    mat_color = getattr(batch, "mat_color_host", None)
    _raster_soup(
        color, depth, pos, batch.tris, view_proj,
        uvs=batch.uvs, tri_texture=batch.tri_texture,
        tri_debug_id=batch.tri_debug_id, textures=batch.textures,
        tri_flat=batch.tri_flat, tri_material=batch.material_ids(),
        mat_color=mat_color,
        blend=True,
    )

    if extra_tris is not None:
        opos, otris, ocolor = extra_tris
        _raster_soup(
            color, depth, np.asarray(opos, np.float32),
            np.asarray(otris, np.int32), view_proj,
            flat_color=np.asarray(ocolor, np.float32) * 255.0,
            blend=False,
        )

    return color.clip(0, 255).astype(np.uint8), depth


def _raster_soup(color, depth, pos, tris, view_proj, uvs=None,
                 tri_texture=None, tri_debug_id=None, textures=None,
                 flat_color=None, tri_flat=None, tri_material=None,
                 mat_color=None, blend=True):
    height, width = depth.shape
    if len(tris) == 0:
        return
    homo = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
    clip = homo @ view_proj.T  # (V, 4)

    for t in range(len(tris)):
        i0, i1, i2 = tris[t]
        c = clip[[i0, i1, i2]]
        w = c[:, 3]
        if np.any(w <= W_EPS):
            continue  # shared near-rejection rule
        inv_w = 1.0 / w
        ndc = c[:, :3] * inv_w[:, None]
        sx = (ndc[:, 0] + 1.0) * 0.5 * width
        sy = (1.0 - ndc[:, 1]) * 0.5 * height
        sz = ndc[:, 2]

        # signed doubled area in y-down screen space; CCW (front) is negative
        area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])
        if area2 >= 0:
            continue  # back-face (or degenerate) cull

        xmin = max(int(np.floor(sx.min())), 0)
        xmax = min(int(np.ceil(sx.max())), width - 1)
        ymin = max(int(np.floor(sy.min())), 0)
        ymax = min(int(np.ceil(sy.max())), height - 1)
        if xmin > xmax or ymin > ymax:
            continue

        px = np.arange(xmin, xmax + 1, dtype=np.float32) + 0.5
        py = np.arange(ymin, ymax + 1, dtype=np.float32) + 0.5
        PX, PY = np.meshgrid(px, py)

        def edge(ax, ay, bx, by):
            return (PX - ax) * (by - ay) - (PY - ay) * (bx - ax)

        # with front faces having area2 < 0 here, the raw edge functions
        # E(a,b)(p) are positive for p inside (E_i = -area2 * b_i)
        e0 = edge(sx[1], sy[1], sx[2], sy[2])
        e1 = edge(sx[2], sy[2], sx[0], sy[0])
        e2 = edge(sx[0], sy[0], sx[1], sy[1])

        # top-left rule: edges exactly on the boundary count when top/left.
        # For this orientation a top edge runs right-to-left (interior
        # below in y-down coords) and a left edge runs downward.
        def topleft(ax, ay, bx, by):
            return (ay == by and bx < ax) or (by > ay)

        inc0 = topleft(sx[1], sy[1], sx[2], sy[2])
        inc1 = topleft(sx[2], sy[2], sx[0], sy[0])
        inc2 = topleft(sx[0], sy[0], sx[1], sy[1])
        cov = (
            ((e0 > 0) | ((e0 == 0) & inc0))
            & ((e1 > 0) | ((e1 == 0) & inc1))
            & ((e2 > 0) | ((e2 == 0) & inc2))
        )
        if not cov.any():
            continue

        area = -(area2)
        b0 = e0 / area
        b1 = e1 / area
        b2 = e2 / area

        z = b0 * sz[0] + b1 * sz[1] + b2 * sz[2]
        zbuf = depth[ymin:ymax + 1, xmin:xmax + 1]
        passing = cov & (z <= zbuf) & (z >= 0.0)
        if not passing.any():
            continue

        # perspective-correct interpolation weights
        pw = b0 * inv_w[0] + b1 * inv_w[1] + b2 * inv_w[2]

        if flat_color is not None:
            src = np.empty(passing.sum().shape + (4,), np.float32)
            frag = np.broadcast_to(flat_color, (int(passing.sum()), 4))
        else:
            tex_id = int(tri_texture[t])
            if tex_id >= 0 and textures:
                uv = uvs[[i0, i1, i2]]
                u = (b0 * uv[0, 0] * inv_w[0] + b1 * uv[1, 0] * inv_w[1]
                     + b2 * uv[2, 0] * inv_w[2]) / pw
                v = (b0 * uv[0, 1] * inv_w[0] + b1 * uv[1, 1] * inv_w[1]
                     + b2 * uv[2, 1] * inv_w[2]) / pw
                frag = sample_bilinear(textures[tex_id], u[passing], v[passing])
            elif tri_flat is not None and tri_flat[t, 3] >= 0:
                frag = np.broadcast_to(
                    tri_flat[t].astype(np.float32), (int(passing.sum()), 4)
                )
            else:
                rgb = DEBUG_PALETTE[int(tri_debug_id[t]) % 20]
                frag = np.broadcast_to(
                    np.array([*rgb, 255], np.float32), (int(passing.sum()), 4)
                )

        if mat_color is not None and flat_color is None:
            frag = frag * mat_color[int(tri_material[t])]

        dst = color[ymin:ymax + 1, xmin:xmax + 1][passing]
        if blend:
            a = frag[:, 3:4] / 255.0
            out = np.empty_like(dst)
            out[:, :3] = frag[:, :3] * a + dst[:, :3] * (1 - a)
            out[:, 3] = frag[:, 3]  # alpha: src*1 + dst*0 (model.rs:245-246)
        else:
            out = frag.astype(np.float32)

        region_c = color[ymin:ymax + 1, xmin:xmax + 1]
        region_c[passing] = out
        zbuf[passing] = z[passing]
