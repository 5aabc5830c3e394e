"""Archive-world scene — a game-scale heterogeneous synthetic level.

The bench's instanced-cube demo exercises raw raster throughput but not
asset DIVERSITY. This builder composes the kind of scene a real archive
produces (reference flow: ``modelviewer.rs:74-160`` loading arbitrary
models/materials/textures from a data root), entirely from parsed
synthetic assets:

* dozens of DISTINCT models (subdivision-varied rich-layout buildings,
  a flattened terrain slab, 8-weight-skinned characters), every one
  parsed through the full rModel -> rMaterial -> rShader2 -> rTexture
  path;
* mixed texture sizes (one texel pool with real mip-table diversity);
* one material SLOT PER INSTANCE with a per-slot tint — hundreds of
  slots, driving ``device._mat_select`` onto its M > 128 gather
  fallback;
* characters instanced with PER-INSTANCE bone palettes: character i
  owns joints ``8i..8i+7`` and its palette is the conjugated base
  animation ``T_i @ M_j @ T_i^-1`` (positions are baked world-space, so
  the conjugation makes each character articulate about its own
  origin), driven by the fixture ``.sdl`` scheduler through
  ``BoneAnimator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dti as dti_mod
from .. import fixtures
from ..formats import mrl, tex
from ..formats.mfx import Shader2File
from ..formats.mod import ModelFile
from ..formats.mrl import MaterialFile
from ..resources.memory import MemoryResourceManager
from .model import DrawBatch, build_draw_batch, merge_many
from .skeleton import Skeleton, mat4_mul

JOINTS_PER_CHAR = 8


def _pattern(size: int, kind: int, rng) -> np.ndarray:
    """Deterministic (size, size, 4) u8 test texture, varied by kind."""
    yy, xx = np.mgrid[0:size, 0:size]
    c0 = rng.integers(40, 255, 3)
    c1 = rng.integers(40, 255, 3)
    if kind == 0:                         # checker, varied cell count
        cells = int(rng.choice([4, 8, 16]))
        mask = ((xx * cells // size) + (yy * cells // size)) % 2 == 0
    elif kind == 1:                       # stripes
        cells = int(rng.choice([4, 8]))
        mask = (xx * cells // size) % 2 == 0
    elif kind == 2:                       # rings
        r = np.hypot(xx - size / 2, yy - size / 2)
        mask = (r * 8 / size).astype(int) % 2 == 0
    else:                                 # gradient threshold blocks
        mask = ((xx + yy) * 6 // (2 * size)) % 2 == 0
    img = np.where(mask[..., None], c0, c1).astype(np.uint8)
    return np.concatenate(
        [img, np.full((size, size, 1), 255, np.uint8)], axis=-1)


def _transform(batch: DrawBatch, *, scale=(1.0, 1.0, 1.0),
               rot_z: float = 0.0, translate=(0.0, 0.0, 0.0)) -> DrawBatch:
    """World placement baked into the vertex data: positions map by
    R_z @ diag(scale), normals by R_z @ diag(1/scale) renormalized."""
    s = np.asarray(scale, np.float32)
    c, sn = np.cos(rot_z), np.sin(rot_z)
    rot = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
    m = rot @ np.diag(s)
    pos = batch.positions @ m.T + np.asarray(translate, np.float32)
    normals = batch.normals
    if normals is not None:
        n = normals @ (rot @ np.diag(1.0 / s)).T
        normals = n / np.maximum(
            np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    return dataclasses.replace(batch, positions=pos.astype(np.float32),
                               normals=normals)


def _char_mat(scale: float, rot_z: float, translate) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    c, sn = np.cos(rot_z), np.sin(rot_z)
    m[:3, :3] = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]],
                         np.float32) * scale
    m[:3, 3] = translate
    return m


class WorldScene:
    """build_world() result: the merged batch plus everything a frame
    loop needs (per-slot tints, per-character transforms, the base
    skeleton + .sdl timeline for palettes)."""

    def __init__(self, batch, mat_color, char_mats, skeleton, timeline,
                 info):
        self.batch = batch
        self.mat_color = mat_color          # (M, 4) f32 0-1 tints
        self.char_mats = char_mats          # (C, 4, 4) f32 placements
        self.char_inv = np.linalg.inv(char_mats) if len(char_mats) \
            else char_mats
        self.skeleton = skeleton            # base 8-joint Skeleton
        self.timeline = timeline            # .sdl Timeline
        self.info = info
        self._char_on: dict = {}     # device -> (char_mats, char_inv)

    def animator(self):
        from .animation import BoneAnimator

        return BoneAnimator(self.timeline, self.skeleton)

    def bone_palette(self, base_mats):
        """(8, 4, 4) base palette -> (8C, 4, 4) per-instance palettes
        T_i @ M_j @ T_i^-1 (world-baked positions articulate about each
        character's own origin). A tensor is conjugated on its own device
        and stays there (a frame loop takes ``bone_mats_device`` to a
        palette without leaving the card); a NumPy array goes through the
        same ops on the CPU, so both give the same bits."""
        if not len(self.char_mats):
            return base_mats
        if not isinstance(base_mats, torch.Tensor):
            return self.bone_palette(torch.as_tensor(
                np.asarray(base_mats, np.float32))).numpy()
        dev = base_mats.device
        if dev not in self._char_on:
            self._char_on[dev] = tuple(
                torch.as_tensor(m, device=dev)[:, None]
                for m in (self.char_mats, self.char_inv))
        cm, ci = self._char_on[dev]
        return mat4_mul(mat4_mul(cm, base_mats.to(torch.float32)[None]),
                        ci).reshape(-1, 4, 4)


def build_world(buildings: int = 140, characters: int = 12,
                variants: int = 24, terrain_subdiv: int = 12,
                building_subdivs=(2, 3, 4, 5, 6, 8),
                tex_sizes=(16, 32, 64, 128, 256),
                seed: int = 7) -> WorldScene:
    """Compose the archive world; deterministic in ``seed``.

    Default scale: ~140 material slots (> 128 -> _mat_select gather
    fallback), 24 distinct parsed building models across 5 texture
    sizes, 12 skinned characters (96-joint combined palette)."""
    rng = np.random.default_rng(seed)
    d = dti_mod.from_name
    shader2 = Shader2File(fixtures.build_shader2())

    def parsed(model_bytes, tex_img, tex_path):
        rm = MemoryResourceManager()
        rm.put(tex_path, d("rTexture"),
               tex.write_texture(tex_img.shape[0], tex_img.shape[1],
                                 int(tex.TextureFormat.RGBA8),
                                 [tex_img.tobytes()]))
        material = MaterialFile(
            mrl.write_material(
                textures=[tex_path],
                materials=[{
                    "name": "fixture_mat",
                    "mat_type": "nDraw::MaterialStd",
                    "texture_states": [("tAlbedoMap", 0)],
                }],
            ), shader2)
        return build_draw_batch(ModelFile(model_bytes), material,
                                shader2, rm)

    # distinct building variants: (subdiv, texture size, pattern)
    variant_batches = []
    for v in range(variants):
        size = int(tex_sizes[v % len(tex_sizes)])
        img = _pattern(size, int(rng.integers(0, 4)), rng)
        sub = int(building_subdivs[v % len(building_subdivs)])
        variant_batches.append(parsed(
            fixtures.build_model_rich(subdiv=sub), img,
            f"model\\world_tex{v}"))

    # characters: the 8-weight skinned fixture, one shared texture
    char_img = _pattern(64, 0, rng)
    char_base = parsed(fixtures.build_model_skin8(), char_img,
                       "model\\world_chartex")
    skeleton = Skeleton.from_model(ModelFile(fixtures.build_model_skin8()))

    # terrain: one big flattened rich slab behind everything
    terr_img = _pattern(128, 3, rng)
    terrain = _transform(
        parsed(fixtures.build_model_rich(subdiv=terrain_subdiv),
               terr_img, "model\\world_terrain"),
        scale=(40.0, 40.0, 0.4), translate=(0.0, 0.0, -2.2))

    side = int(np.ceil(np.sqrt(buildings)))
    batches = [terrain]
    for b in range(buildings):
        var = variant_batches[int(rng.integers(0, variants))]
        gx = (b % side - (side - 1) / 2) * 3.0 + rng.uniform(-0.7, 0.7)
        gy = (b // side - (side - 1) / 2) * 3.0 + rng.uniform(-0.7, 0.7)
        s = rng.uniform(0.55, 1.35)
        batches.append(_transform(
            var, scale=(s, s * rng.uniform(0.8, 1.8), s),
            rot_z=rng.uniform(0, 2 * np.pi),
            translate=(gx, gy, rng.uniform(-0.4, 0.4))))

    char_mats = []
    for ci in range(characters):
        m = _char_mat(
            float(rng.uniform(0.8, 1.2)),
            float(rng.uniform(0, 2 * np.pi)),
            np.array([(ci - (characters - 1) / 2) * 2.6,
                      -side * 1.6 - 2.0, 1.2], np.float32))
        char_mats.append(m)
        cb = dataclasses.replace(
            char_base,
            joints=char_base.joints + JOINTS_PER_CHAR * ci)
        pos = np.concatenate(
            [char_base.positions,
             np.ones((char_base.num_vertices, 1), np.float32)], axis=1)
        cb = dataclasses.replace(
            cb, positions=(pos @ m.T)[:, :3].astype(np.float32))
        batches.append(cb)
    char_mats = (np.stack(char_mats) if char_mats
                 else np.zeros((0, 4, 4), np.float32))

    batch = merge_many(batches)
    nj = JOINTS_PER_CHAR * max(characters, 1)
    # combined palette metadata: per-character copies of the base
    # skeleton (parents/offsets shift by 8i; identity inverse binds)
    p8 = (skeleton.parents if characters else np.full(8, -1))
    batch.joint_parents = np.concatenate(
        [np.where(p8 < 0, -1, p8 + JOINTS_PER_CHAR * i)
         for i in range(max(characters, 1))]).astype(np.int32)
    batch.joint_offsets = np.tile(
        np.zeros((JOINTS_PER_CHAR, 3), np.float32),
        (max(characters, 1), 1))
    batch.inverse_bind_mats = np.tile(
        np.eye(4, dtype=np.float32), (nj, 1, 1))
    batch.skinned = characters > 0

    m = batch.num_materials
    mat_color = np.ones((m, 4), np.float32)
    # slot tints: terrain + buildings get muted per-instance colors;
    # characters stay untinted (texture speaks)
    tints = rng.uniform(0.55, 1.0, (1 + buildings, 3)).astype(np.float32)
    mat_color[:1 + buildings, :3] = tints
    batch.mat_color_host = mat_color      # picked up by the CPU oracle

    from ..formats.sdl import SchedulerFile
    from .animation import Timeline

    timeline = Timeline(SchedulerFile(fixtures.build_scheduler_bones()))

    info = {
        "models_distinct": variants + 2,
        "buildings": buildings, "characters": characters,
        "materials": m, "textures": len(batch.textures),
        "tex_sizes": sorted({t.shape[0] for t in batch.textures}),
        "tris": batch.num_triangles, "verts": batch.num_vertices,
        "joints": nj,
    }
    return WorldScene(batch, mat_color, char_mats, skeleton, timeline,
                      info)


def world_camera(width: int, height: int, buildings: int = 140):
    """Frame the world from a raised three-quarter view."""
    from ..app.camera import Camera

    side = int(np.ceil(np.sqrt(buildings)))
    dist = max(6.0, side * 3.0)
    cam = Camera(position=[0.0, -dist * 0.12, dist],
                 yaw=8.0, pitch=-9.0, far=max(80.0, dist * 6.0))
    cam.aspect = width / height
    return cam
