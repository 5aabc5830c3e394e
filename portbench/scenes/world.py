"""The archive world: a terrain slab, ``buildings`` placed instances of
``variants`` distinct subdivided-cube buildings over mixed texture
sizes, and ``characters`` 8-weight skinned characters, one material
slot per instance (terrain, buildings, characters: 293 slots at 280
buildings).

A frozen copy of the program's world builder: the placement draws come
from ``layout_seed`` in the same order, so the layout, the triangle
count (239,664 at 280 buildings) and the slot count are the bench's
own at every run seed. The run's seed draws the textures' content and
the per-slot tints.
"""

from __future__ import annotations

import numpy as np

from . import SceneArrays, corner_cube, pattern, subdivided_cube

# the skin of every character: vertex v blends joints (v + k) mod 8
# with these u8 weights (summing to 255)
SKIN8 = np.array([64, 48, 40, 32, 28, 20, 16, 7], np.float32) / 255.0


def _layout_pattern_draws(rng, kind: int) -> None:
    """Consume the layout generator's draws of one texture pattern (the
    program's builder draws its textures from the same stream)."""
    rng.integers(40, 255, 3)
    rng.integers(40, 255, 3)
    if kind == 0:
        rng.choice([4, 8, 16])
    elif kind == 1:
        rng.choice([4, 8])


def _place(pos, scale, rot_z, translate):
    c, s = np.cos(rot_z), np.sin(rot_z)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    m = rot @ np.diag(np.asarray(scale, np.float32))
    return (pos @ m.T + np.asarray(translate, np.float32)).astype(np.float32)


def char_matrix(scale: float, rot_z: float, translate) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(rot_z), np.sin(rot_z)
    m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                         np.float32) * scale
    m[:3, 3] = translate
    return m


def build(cfg: dict, seed: int) -> SceneArrays:
    lay = np.random.default_rng(cfg["layout_seed"])
    rng = np.random.default_rng(seed)
    nv, nb, nc = cfg["variants"], cfg["buildings"], cfg["characters"]
    tex_sizes, subdivs = cfg["tex_sizes"], cfg["building_subdivs"]

    variants = []                       # (positions, uvs, tris, size)
    for v in range(nv):
        _layout_pattern_draws(lay, int(lay.integers(0, 4)))
        variants.append(subdivided_cube(int(subdivs[v % len(subdivs)]))
                        + (int(tex_sizes[v % len(tex_sizes)]),))
    _layout_pattern_draws(lay, 0)       # the characters' texture
    _layout_pattern_draws(lay, 3)       # the terrain's texture

    parts = []      # (positions, uvs, tris, texture key, joints, weights)
    tpos, tuv, ttri = subdivided_cube(cfg["terrain_subdiv"])
    parts.append((_place(tpos, cfg["terrain_scale"], 0.0,
                         cfg["terrain_translate"]), tuv, ttri, "terrain",
                  None, None))
    side = int(np.ceil(np.sqrt(nb)))
    for b in range(nb):
        vi = int(lay.integers(0, nv))
        gx = (b % side - (side - 1) / 2) * 3.0 + lay.uniform(-0.7, 0.7)
        gy = (b // side - (side - 1) / 2) * 3.0 + lay.uniform(-0.7, 0.7)
        s = lay.uniform(0.55, 1.35)
        sy = s * lay.uniform(0.8, 1.8)
        rot = lay.uniform(0, 2 * np.pi)
        tz = lay.uniform(-0.4, 0.4)
        pos, uv, tri, _ = variants[vi]
        parts.append((_place(pos, (s, sy, s), rot, (gx, gy, tz)), uv, tri,
                      vi, None, None))
    cpos, cuv, ctri = corner_cube()
    char_mats = []
    for ci in range(nc):
        m = char_matrix(float(lay.uniform(0.8, 1.2)),
                        float(lay.uniform(0, 2 * np.pi)),
                        np.array([(ci - (nc - 1) / 2) * 2.6,
                                  -side * 1.6 - 2.0, 1.2], np.float32))
        char_mats.append(m)
        homo = np.concatenate([cpos, np.ones((len(cpos), 1), np.float32)], 1)
        j = (np.arange(8)[None] + np.arange(len(cpos))[:, None]) % 8
        parts.append(((homo @ m.T)[:, :3].astype(np.float32), cuv, ctri,
                      "character", (j + 8 * ci).astype(np.int32),
                      np.tile(SKIN8, (len(cpos), 1))))

    # textures in order of first use, as the program's merge keeps them
    tex_ids, textures = {}, []
    for p in parts:
        if p[3] not in tex_ids:
            tex_ids[p[3]] = len(textures)
            size = {"terrain": cfg["terrain_tex"],
                    "character": cfg["character_tex"]}.get(p[3])
            textures.append(pattern(size or variants[p[3]][3], rng))

    pos, uv, tris, ttex, tmat, jn, wt = [], [], [], [], [], [], []
    v0 = 0
    for slot, (p, u, t, key, j, w) in enumerate(parts):
        pos.append(p)
        uv.append(u)
        tris.append(t + v0)
        ttex.append(np.full(len(t), tex_ids[key], np.int32))
        tmat.append(np.full(len(t), slot, np.int32))
        jn.append(j if j is not None else np.zeros((len(p), 8), np.int32))
        wt.append(w if w is not None else np.zeros((len(p), 8), np.float32))
        v0 += len(p)
    mat_color = np.ones((len(parts), 4), np.float32)
    mat_color[:1 + nb, :3] = rng.uniform(0.55, 1.0, (1 + nb, 3))
    anim = dict(cfg["animation"])
    anim["characters"] = np.stack(char_mats)
    return SceneArrays(
        positions=np.concatenate(pos), uvs=np.concatenate(uv),
        joints=np.concatenate(jn), weights=np.concatenate(wt),
        tris=np.concatenate(tris).astype(np.int32),
        tri_texture=np.concatenate(ttex), tri_material=np.concatenate(tmat),
        mat_color=mat_color, textures=textures, num_joints=8 * nc,
        animation=anim)
