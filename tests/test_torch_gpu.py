"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, so every pytest worker collects the same tests). The
file imports no jax, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: none. K1, K2 and K3 are built without FMA contraction, so
they round every plane evaluation like the plain versions' separate ops:
their outputs are expected bit-equal (K1's mtap and lit epilogues on the
demo scene are held to 2 ulp, with ids, coverage and tap addresses
exact; K2's to 0 ulp). K4 is integer arithmetic: bit-equal. The frames on the card are
held to the CPU's under the golden rule (coverage exact, at most 0.3% of
pixels with a channel off by more than 1); the animated palette of the
world, computed on the card, equals the host's bit for bit. The tri,
bc1 and bc7 pools built on the card equal the CPU's builds, the BC7
decodes on the card the NumPy decoder, and the bc1, bc7 and narrow
frames on the card equal their decoded-chains and quad pools' frames
there bit for bit; the reference bench's verify legs pass on the card.
The viewers' torch stages give the CPU's bits on the card (the HUD
composite, the texture view), and ``modelviewer --demo`` on the card
launches K1 in every frame with no overflow, its frame under the golden
rule against the CPU's. The frame served from ``serving.export_render``'s
program equals ``render_frame`` bit for bit on the card, eager and as
replays of its CUDA graph (a bc7 world's too, its replays advancing
the bc7 kernel's counters as the eager call does), K1's two ops
pass ``torch.library.opcheck`` on CUDA inputs, and a CPU artifact
refuses card tensors. K1's zlow instantiations and its attrs epilogue
equal the plain version bit for bit on the hard inputs; pass 0 of the
multipass peel equals the single-layer frame bit for bit on the card;
the scan backend's frames on the card lie under the golden rule against
the CPU's (coverage exact, depth within 1e-5). The frame engine's cap
guard, counted on the card, holds a 20-frame headline orbit at 1920x1080
with no overflow, each frame ``render_frame``'s at the engine's caps.
The bc7 trilinear kernel equals its plain twin, on the card and on the
CPU, bit for bit on ``bc7_taps``' cases, and a bc7 ``FrameEngine``'s
every frame shades through it.
"""

import os

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.app.camera import Camera
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.scene import demo
from mt_renderer_tpu_torch.scene.model import DrawBatch
from mt_renderer_tpu_torch.utils import profiling

import bc7_taps
from test_torch_k1_cull import adversarial_cols, heavy_tile_case
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _glass(instances=9, subdiv=2, width=W, height=H):
    """The glass demo scene (every 4th instance translucent, the camera
    inside the field) → (batch, view_proj, bones)."""
    batch = demo.make_translucent(demo.build_demo_batch(
        instances=instances, skinned=True, subdiv=subdiv), instances)
    cam = demo.demo_camera(instances, width, height)
    cam.position = cam.position * 0.3
    return batch, np.asarray(cam.view_proj()), demo.demo_bone_mats(0.5)


def stack_batch(seed: int = 0, quads: int = 12) -> DrawBatch:
    """A seeded stack of overlapping, textured, screen-facing quads, one
    per depth in [-1, 0.8): about a third opaque, the rest alpha 100.
    Under ``stack_view_proj`` most pixels see many fragments, so K2's
    lists fill to any depth. (The demo cubes seldom overlap more than
    twice.)"""
    rng = np.random.default_rng(seed)
    textures = []
    for alpha in (255, 100):
        tex = rng.integers(0, 256, (8, 8, 4)).astype(np.uint8)
        tex[..., 3] = alpha
        textures.append(tex)
    pos, uvs, tris, tex_ids = [], [], [], []
    for i in range(quads):
        z = -1.0 + 1.8 * i / quads
        cx, cy = rng.uniform(-0.6, 0.6, 2)
        s = rng.uniform(0.5, 1.3)
        b = len(pos)
        pos += [[cx - s, cy - s, z], [cx + s, cy - s, z],
                [cx - s, cy + s, z], [cx + s, cy + s, z]]
        uvs += [[0, 0], [1, 0], [0, 1], [1, 1]]
        tris += [[b, b + 1, b + 2], [b + 2, b + 1, b + 3]]
        tex_ids += [int(rng.random() > 1 / 3)] * 2
    n, t = len(pos), len(tris)
    return DrawBatch(
        positions=np.asarray(pos, np.float32),
        uvs=np.asarray(uvs, np.float32),
        joints=np.zeros((n, 4), np.int32),
        weights=np.zeros((n, 4), np.float32),
        tris=np.asarray(tris, np.int32),
        tri_texture=np.asarray(tex_ids, np.int32),
        tri_parts=np.zeros(t, np.int32),
        tri_debug_id=np.zeros(t, np.int32),
        textures=textures)


def stack_view_proj(width: int, height: int) -> np.ndarray:
    cam = Camera(position=[0.0, 0.0, 3.0])
    cam.aspect = width / height
    return np.asarray(cam.view_proj())


def with_normals(batch):
    """Unit normals pointing away from the batch's centroid: the demo
    scene carries none, and without them the lambert factor is a
    constant."""
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return batch


def _binned(device, *, maxc=None, instances=9, subdiv=2, width=W,
            height=H, glass=None, lighting=False):
    """The port's own vertex, setup and binning stages on ``device`` →
    the raster's positional arguments. ``glass`` bins the glass scene
    instead of the demo scene: "all" its every triangle, "opaque" or
    "translucent" one set of its opacity split; "stack" bins
    ``stack_batch`` instead. ``lighting`` gives the glass scene unit
    normals and sets up the lit column matrix."""
    if glass == "stack":
        batch, vp, bones = stack_batch(), stack_view_proj(width, height), None
    elif glass:
        batch, vp, bones = _glass(instances, subdiv, width, height)
        if lighting:
            batch = with_normals(batch)
    else:
        batch = demo.build_demo_batch(instances=instances, skinned=True,
                                      subdiv=subdiv)
        vp = np.asarray(demo.demo_camera(instances, width,
                                         height).view_proj())
        bones = demo.demo_bone_mats(0.5)
    if maxc is None:
        maxc = td.auto_maxc(batch, vp, bones, width=width, height=height)
    scene = td.upload(batch, device=device)
    clip = td.vertex_stage(scene, vp, bones)
    lit = dict(bone_mats=bones, lighting=lighting)
    if glass in ("opaque", "translucent"):
        setup = td.setup_packed_cols(scene, clip, width, height,
                                     opacity_split=True, **lit)
        cols, bbox = setup[glass == "translucent"]
    else:
        cols, bbox = td.setup_packed_cols(scene, clip, width, height, **lit)
    lists, glists, counts, n_over = tr.prebin(cols, bbox, 0, 0, width=width,
                                              height=height, maxc=maxc)
    return (cols, lists, glists, counts, (0, 0)), n_over


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(),
    # 64 instances piled into few tiles: maxc=1 drops chunks
    dict(maxc=1, instances=64, subdiv=0, width=128, height=64),
], ids=["auto_maxc", "overflowing"])
def test_kernel_matches_plain_version(cuda, case):
    """Auto-sized and overflowing chunk lists."""
    args, n_over = _binned(cuda, **case)
    kw = dict(width=case.get("width", W), height=case.get("height", H),
              w_eps=td.W_EPS)
    before = tr.raster_fwd.launches
    got = tr.raster_fwd(*args, **kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd.launches == before + 1
    assert (int(n_over) > 0) == ("maxc" in case)
    want = tr.raster_fwd_reference(*args, **kw)
    assert 0.05 < float((want[1] >= 0).float().mean()) < 0.95
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_kernel_band_origin_and_empty_tiles(cuda):
    """A band with a nonzero origin whose tiles have empty lists."""
    (cols, *_), _ = _binned(cuda)
    bbox = tuple(torch.full((cols.shape[1] // tr.KG,), v, device=cuda)
                 for v in (1e30, -1e30, 1e30, -1e30, 1e30))
    lists, glists, counts, _ = tr.prebin(cols, bbox, 128, 32, width=128,
                                         height=32, maxc=4)
    zb, ib, tattrs, tapidx = tr.raster_fwd(
        cols, lists, glists, counts, (128, 32), width=128, height=32,
        w_eps=td.W_EPS)
    torch.cuda.synchronize()
    assert (ib == -1).all() and (zb == 1.0).all()
    assert (tapidx == 0).all() and (tattrs == 0).all()


@pytest.mark.gpu
def test_packed_frame_on_card_matches_cpu(cuda):
    """The whole packed frame on the card against the same frame on the
    CPU (plain raster): coverage exact, at most 0.3% of pixels with a
    channel off by more than 1."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=2)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.5)
    maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
    taps = td.auto_tap_tiles(batch, vp, bones, width=W, height=H)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = td.render_frame(
            td.upload(batch, device=dev), vp, bones, width=W, height=H,
            packed=True, maxc=maxc, tap_tiles=taps)
    tr.flush_overflow_checks()
    (gc, gd), (wc, wd) = out["cuda"], out["cpu"]
    assert gc.device.type == "cuda" and gc.dtype == torch.int32
    assert torch.equal(gd.cpu() < 1.0, wd < 1.0)
    diff = np.abs(td.unpack_rgba(gc).astype(np.int32)
                  - td.unpack_rgba(wc).astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.003


def _opaque_horizon(device, lighting=False):
    """K1's opaque z-buffer of the glass scene, +inf where uncovered: the
    split peel's ``zhi`` for K2."""
    args, _ = _binned(device, glass="opaque", lighting=lighting)
    zo, io = tr.raster_fwd(*args, width=W, height=H, w_eps=td.W_EPS)[:2]
    return torch.where(io >= 0, zo, float("inf"))


def _hard_ml_case(variant: str, lit: bool = False):
    """K2's inputs on the adversarial or heavy-tile scene of
    ``test_torch_k2_cull.k2_case`` ("<scene>_<variant>", on the CPU), the
    lit matrix with 9 seeded normal rows → (args, keywords but
    ``layers``)."""
    from test_torch_k2_cull import k2_case

    scene, kind = variant.split("_", 1)
    args, kw = k2_case(scene, kind)
    cols = args[0][:tr.N_RAST + tr.N_COEF]
    if lit:
        rng = np.random.default_rng(7)
        cols = torch.cat([cols, torch.from_numpy(rng.uniform(
            -1, 1, (tr.N_COEF_LIT - tr.N_COEF, cols.shape[1])).astype(
                np.float32))])
    return (cols, *args[1:]), dict(kw, light=td._light_unit() if lit
                                   else None)


HARD_ML = [f"{scene}_{v}" for scene in ("adversarial", "heavy")
           for v in ("full", "full_zhi", "nocull", "nocull_zhi")]


def _to(x, dev):
    return x.to(dev) if torch.is_tensor(x) else x


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [2, 4, 8])
@pytest.mark.parametrize("variant", ["full", "nocull_zhi", "full_stack",
                                     "nocull_stack", *HARD_ML])
def test_ml_kernel_matches_plain_version(cuda, layers, variant):
    """K2 on the glass scene ("full" over every triangle, "nocull" over
    the translucent set behind K1's opaque z-buffer), on the deep quad
    stack (both variants, no horizon), and on K1's adversarial and
    heavy-tile scenes (full and nocull, each with and without a seeded
    horizon holding -0.0, negative, +inf and NaN pixels): bit for bit."""
    if variant in HARD_ML:
        args, kw = _hard_ml_case(variant)
        kw.update(layers=layers)
        want = tr.raster_fwd_ml_reference(*args, **kw)
        before = tr.raster_fwd_ml.launches
        got = tr.raster_fwd_ml(*(_to(a, cuda) for a in args),
                               **{k: _to(v, cuda) for k, v in kw.items()})
        torch.cuda.synchronize()
        assert tr.raster_fwd_ml.launches == before + 1
        assert bool((want[1] >= 0).any())
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.cpu(), w)
        return
    if variant == "full":
        args, _ = _binned(cuda, glass="all")
        kw = dict(opaque_cull=True, zhi=None)
    elif variant == "nocull_zhi":
        args, _ = _binned(cuda, glass="translucent")
        kw = dict(opaque_cull=False, zhi=_opaque_horizon(cuda))
    else:
        args, _ = _binned(cuda, glass="stack")
        kw = dict(opaque_cull=variant == "full_stack", zhi=None)
    kw.update(width=W, height=H, layers=layers, w_eps=td.W_EPS)
    before = tr.raster_fwd_ml.launches
    got = tr.raster_fwd_ml(*args, **kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd_ml.launches == before + 1
    want = tr.raster_fwd_ml_reference(*args, **kw)
    assert float((want[1][:, 0] >= 0).float().mean()) > 0.01
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [2, 4, 8])
@pytest.mark.parametrize("variant", ["full", "nocull_zhi",
                                     "adversarial_full",
                                     "adversarial_nocull_zhi", "heavy_full",
                                     "heavy_nocull_zhi"])
@pytest.mark.parametrize("mode,lit", [("mtap", False), ("mtap", True),
                                      ("tap", True)])
def test_ml_kernel_epilogues_match_plain_version(cuda, layers, variant, mode,
                                                 lit):
    """K2's mtap and lit epilogues on the glass scene with unit normals
    ("full" over every triangle, "nocull" over the translucent set
    behind K1's opaque z-buffer) and on K1's adversarial and heavy-tile
    scenes (their seeded horizon with "nocull", seeded normal rows when
    lit). Ids, coverage and tap addresses exact, z and every plane at
    0 ulp."""
    if variant.startswith(("adversarial", "heavy")):
        args, kw = _hard_ml_case(variant, lit)
        kw.update(layers=layers, mode=mode)
        want = tr.raster_fwd_ml_reference(*args, **kw)
        args = tuple(_to(a, cuda) for a in args)
        kw = {k: _to(v, cuda) for k, v in kw.items()}
    else:
        glass = "all" if variant == "full" else "translucent"
        args, _ = _binned(cuda, glass=glass, lighting=lit)
        kw = dict(opaque_cull=variant == "full",
                  zhi=(None if variant == "full"
                       else _opaque_horizon(cuda, lit)),
                  width=W, height=H, layers=layers, w_eps=td.W_EPS,
                  mode=mode, light=td._light_unit() if lit else None)
        want = tr.raster_fwd_ml_reference(*args, **kw)
    before = tr.raster_fwd_ml.launches
    got = tr.raster_fwd_ml(*args, **kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd_ml.launches == before + 1
    got = tuple(g.cpu() for g in got)
    want = tuple(w.cpu() for w in want)
    n_planes = tr.ATTRS_MTAP if mode == "mtap" else tr.ATTRS_TAP
    assert len(got) == len(want) == (3 if mode == "mtap" else 4)
    assert tuple(got[2].shape) == (args[3].shape[0], layers * n_planes, tr.P)
    assert float((want[1][:, 0] >= 0).float().mean()) > 0.01
    assert torch.equal(got[1], want[1])
    if mode == "tap":
        assert torch.equal(got[3], want[3])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.shape == w.shape
        assert int(ulp_dist(g, w).max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tap", "mtap"])
def test_ml_kernel_empty_translucent_feed(cuda, mode):
    """The split peel of an opaque scene hands K2 an empty translucent
    set: it launches and returns empty layers."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=2)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    scene = td.upload(batch, device=cuda)
    _, (cols, bbox) = td.setup_packed_cols(
        scene, td.vertex_stage(scene, vp, demo.demo_bone_mats(0.5)), W, H,
        opacity_split=True)
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=W,
                                         height=H, maxc=8)
    assert int(counts.max()) == 0
    got = tr.raster_fwd_ml(cols, lists, glists, counts, (0, 0), width=W,
                           height=H, layers=4, w_eps=td.W_EPS,
                           opaque_cull=False, mode=mode)
    torch.cuda.synchronize()
    assert (got[1] == -1).all() and (got[0] == 1.0).all()
    assert (got[2] == 0).all()


@pytest.mark.gpu
def test_ml_kernel_overflowing_lists(cuda):
    """maxc=1 drops chunks: both versions skip the same ones."""
    args, n_over = _binned(cuda, maxc=1, instances=64, subdiv=0, width=128,
                           height=64)
    assert int(n_over) > 0
    kw = dict(width=128, height=64, layers=3, w_eps=td.W_EPS,
              opaque_cull=True)
    got = tr.raster_fwd_ml(*args, **kw)
    want = tr.raster_fwd_ml_reference(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_ml_kernel_band_origin_and_empty_tiles(cuda):
    """A band with a nonzero origin: its top tiles hold the scene, the
    tiles below the frame have empty lists."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=2)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    scene = td.upload(batch, device=cuda)
    cols, bbox = td.setup_packed_cols(
        scene, td.vertex_stage(scene, vp, demo.demo_bone_mats(0.5)), W, H)
    lists, glists, counts, _ = tr.prebin(cols, bbox, 128, 32, width=128,
                                         height=256, maxc=16)
    empty = counts == 0
    assert bool(empty.any()) and int(counts.max()) > 0
    kw = dict(width=128, height=256, layers=4, w_eps=td.W_EPS,
              opaque_cull=True)
    got = tr.raster_fwd_ml(cols, lists, glists, counts, (128, 32), **kw)
    want = tr.raster_fwd_ml_reference(cols, lists, glists, counts,
                                      (128, 32), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1][empty] == -1).all() and (got[0][empty] == 1.0).all()


@pytest.mark.gpu
def test_split_frame_on_card_matches_cpu(cuda):
    """The packed split-peel frame of the glass scene on the card against
    the same frame on the CPU (plain rasters), with measured caps."""
    batch, vp, bones = _glass(instances=16)
    maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
    out = {}
    for dev in ("cpu", cuda):
        scene = td.upload(batch, device=dev)
        caps = td.measure_live_tap_tiles(scene, vp, bones, width=W,
                                         height=H, layers=4, maxc=maxc,
                                         mode="split")
        out[str(dev)] = caps, td.render_frame_peeled(
            scene, vp, bones, width=W, height=H, layers=4, maxc=maxc,
            peel_mode="split", packed=True, tap_tiles=caps)
    tr.flush_overflow_checks()
    (gcaps, (gc, gd)), (wcaps, (wc, wd)) = out["cuda"], out["cpu"]
    assert gcaps == wcaps
    assert gc.device.type == "cuda" and gc.dtype == torch.int32
    assert torch.equal(gd.cpu() < 1.0, wd < 1.0)
    diff = np.abs(td.unpack_rgba(gc).astype(np.int32)
                  - td.unpack_rgba(wc).astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.003


def ulp_dist(a, b):
    """Per-element distance in units in the last place of two f32
    tensors (0 for +0 vs -0)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(2**31) - i, i)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,lit", [("tap", True), ("mtap", False),
                                      ("mtap", True)])
def test_kernel_epilogues_match_plain_version(cuda, mode, lit):
    """K1's mtap and lit epilogues on the demo scene with unit normals
    (it carries none; without them the lambert factor is a constant):
    ids, coverage and tap addresses exact, every plane within 2 ulp
    (bit-equal expected: no FMA contraction on either side)."""
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=2)
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    bones = demo.demo_bone_mats(0.5)
    scene = td.upload(batch, "tri", device=cuda)
    cols, bbox = td.setup_packed_cols(scene, td.vertex_stage(scene, vp,
                                                             bones),
                                      W, H, bone_mats=bones, lighting=lit)
    pre = tr.prebin(cols, bbox, 0, 0, width=W, height=H,
                    maxc=td.auto_maxc(batch, vp, bones, width=W, height=H))
    kw = dict(width=W, height=H, w_eps=td.W_EPS, mode=mode,
              light=td._light_unit() if lit else None)
    before = tr.raster_fwd.launches
    got = tr.raster_fwd(cols, *pre[:3], (0, 0), **kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd.launches == before + 1
    want = tr.raster_fwd_reference(cols, *pre[:3], (0, 0), **kw)
    assert len(got) == len(want) == (4 if mode == "tap" else 3)
    assert torch.equal(got[1], want[1])
    assert 0.05 < float((want[1] >= 0).float().mean()) < 0.95
    if mode == "tap":
        assert torch.equal(got[3], want[3])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert g.shape == w.shape
        assert int(ulp_dist(g, w).max()) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["adversarial", "heavy_tile"])
@pytest.mark.parametrize("mode,lit", [("tap", False), ("tap", True),
                                      ("mtap", False), ("mtap", True)])
def test_kernel_matches_plain_version_on_hard_inputs(cuda, scene, mode, lit):
    """K1's cull and ring on inputs built to break them, bit for bit in
    every instantiation: the adversarial setup of
    ``test_torch_k1_cull.py`` (edges through pixel centers, top-left
    ties, slivers, REJECT rows that overflow to +inf, clipped
    coefficients, NaN and inf rows, z = -0.0 ties; every chunk in every
    tile) and the heavy tile (256 instances framed into four tiles, a
    long list each). The lit instantiations read 9 more seeded
    coefficient rows as the normal planes."""
    if scene == "adversarial":
        args = (*adversarial_cols(), (0, 0))
        kw = dict(width=W, height=H)
    else:
        args, kw = heavy_tile_case()
    cols = args[0]
    if lit:
        rng = np.random.default_rng(7)
        normals = torch.from_numpy(rng.uniform(
            -1, 1, (tr.N_COEF_LIT - tr.N_COEF, cols.shape[1])).astype(
                np.float32))
        cols = torch.cat([cols[:tr.N_RAST + tr.N_COEF], normals])
    args = (cols, *args[1:])
    kw.update(w_eps=td.W_EPS, mode=mode,
              light=td._light_unit() if lit else None)
    want = tr.raster_fwd_reference(*args, **kw)
    dev_args = [x.to(cuda) if torch.is_tensor(x) else x for x in args]
    before = tr.raster_fwd.launches
    got = tr.raster_fwd(*dev_args, **kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd.launches == before + 1
    assert 0.05 < float((want[1] >= 0).float().mean())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            assert int(ulp_dist(g, w).max()) == 0


def _hard_args(scene: str, lit: bool):
    """The adversarial or heavy-tile raster inputs (lit: 9 more seeded
    coefficient rows as the normal planes) → (args, kw)."""
    if scene == "adversarial":
        args = (*adversarial_cols(), (0, 0))
        kw = dict(width=W, height=H)
    else:
        args, kw = heavy_tile_case()
    cols = args[0]
    if lit:
        rng = np.random.default_rng(7)
        normals = torch.from_numpy(rng.uniform(
            -1, 1, (tr.N_COEF_LIT - tr.N_COEF, cols.shape[1])).astype(
                np.float32))
        cols = torch.cat([cols[:tr.N_RAST + tr.N_COEF], normals])
    return (cols, *args[1:]), kw


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["adversarial", "heavy_tile"])
@pytest.mark.parametrize("mode,lit,zlow", [
    ("tap", False, True), ("tap", True, True), ("mtap", False, True),
    ("mtap", True, True), ("attrs", False, False), ("attrs", True, False),
    ("attrs", False, True), ("attrs", True, True)])
def test_kernel_zlow_and_attrs_match_plain_version(cuda, scene, mode, lit,
                                                   zlow):
    """K1's zlow instantiations and its attrs epilogue, bit for bit, on
    the inputs built to break its cull and ring. ``zlow`` is the
    multipass peel's: pass 0's depth + PEEL_EPS where it covered, +inf
    where not, with one tile row at -inf (no exclusion)."""
    args, kw = _hard_args(scene, lit)
    kw.update(w_eps=td.W_EPS, light=td._light_unit() if lit else None)
    if zlow:
        zb, ib = tr.raster_fwd_reference(*args, **kw)[:2]
        zl = torch.where(ib >= 0, zb + td.PEEL_EPS, float("inf"))
        zl[:, :, :tr.TILE_W] = -float("inf")
        kw["zlow"] = zl
    kw["mode"] = mode
    want = tr.raster_fwd_reference(*args, **kw)
    dev_kw = dict(kw, zlow=None if not zlow else kw["zlow"].to(cuda))
    dev_args = [x.to(cuda) if torch.is_tensor(x) else x for x in args]
    before = tr.raster_fwd.launches
    got = tr.raster_fwd(*dev_args, **dev_kw)
    torch.cuda.synchronize()
    assert tr.raster_fwd.launches == before + 1
    assert float((want[1] >= 0).float().mean()) > (0.002 if zlow else 0.05)
    assert len(got) == len(want) == (4 if mode == "tap" else 3)
    assert got[2].shape[1] == tr.n_planes(mode, kw["light"])
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            assert int(ulp_dist(g, w).max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mipmap,lit", [(False, False), (False, True),
                                        (True, False)])
def test_multipass_pass0_on_card_equals_single_layer_frame(cuda, mipmap,
                                                           lit):
    """Pass 0 of the multipass peel (L = 1) is the single-layer frame on
    the card, bit for bit; the L = 3 peel launches K1 three times and
    lies under the golden rule against the same peel on the CPU."""
    batch, vp, bones = _glass()
    batch = with_normals(batch)
    kw = dict(width=W, height=H, mipmap=mipmap, lighting=lit)
    scene = td.upload(batch, "tri", device=cuda)
    a, da = td.render_frame_peeled(scene, vp, bones, layers=1,
                                   peel_mode="multipass", **kw)
    b, db = td.render_frame(scene, vp, bones, **kw)
    assert torch.equal(a, b) and torch.equal(da, db)
    before = tr.raster_fwd.launches
    got, got_d = td.render_frame_peeled(scene, vp, bones, layers=3,
                                        peel_mode="multipass", **kw)
    assert tr.raster_fwd.launches == before + 3
    want, want_d = td.render_frame_peeled(td.upload(batch, "tri",
                                                    device="cpu"), vp, bones,
                                          layers=3, peel_mode="multipass",
                                          **kw)
    assert torch.equal(got_d.cpu() < 1.0, want_d < 1.0)
    diff = (got.cpu().int() - want.int()).abs().amax(-1)
    assert float((diff > 1).float().mean()) <= 0.003


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["single", "peeled", "mip_lit", "bc7"])
def test_scan_frame_on_card_matches_cpu(cuda, what):
    """The scan backend on the card against the same frame on the CPU:
    coverage exact, depth within 1e-5, color under the golden rule."""
    batch, vp, bones = _glass()
    batch = with_normals(batch)
    pool = "bc7" if what == "bc7" else "quad"
    kw = dict(width=W, height=H, backend="scan",
              mipmap=what == "mip_lit", lighting=what == "mip_lit")
    frames = []
    for dev in (cuda, "cpu"):
        scene = td.upload(batch, pool, device=dev)
        if what == "peeled":
            frames.append(td.render_frame_peeled(scene, vp, bones, layers=3,
                                                 **kw))
        else:
            frames.append(td.render_frame(scene, vp, bones, **kw))
    (got, got_d), (want, want_d) = frames
    got, got_d = got.cpu(), got_d.cpu()
    assert torch.equal(got_d < 1.0, want_d < 1.0)
    assert float((got_d - want_d).abs().max()) <= 1e-5
    diff = (got.int() - want.int()).abs().amax(-1)
    assert float((diff > 1).float().mean()) <= 0.003
    assert bool((want_d < 1.0).any())


@pytest.mark.gpu
def test_micro_kernel_matches_plain_version(cuda):
    """K3 on chunk 0 of the demo scene's setup at 128x16: every CTA's row
    equal to the others and to the plain probe, bit for bit."""
    scene = td.upload(demo.build_demo_batch(instances=4, skinned=True,
                                            subdiv=1), device=cuda)
    vp = np.asarray(demo.demo_camera(4, 128, 16).view_proj())
    cols, _ = td.setup_packed_cols(scene, td.vertex_stage(
        scene, vp, demo.demo_bone_mats(0.3)), 128, 16)
    chunk = cols[:, :tr.CT].contiguous()
    before = tr.raster_micro.launches
    got = tr.raster_micro(chunk, 3, tr.N_COEF)
    torch.cuda.synchronize()
    assert tr.raster_micro.launches == before + 1
    props = torch.cuda.get_device_properties(cuda)
    assert got[0].shape[0] == tr.card_rows(cuda) == (
        props.multi_processor_count * tr.blocks_per_sm(cuda) // tr.PARTS)
    want = tr.raster_micro_reference(chunk, 3, tr.N_COEF)
    assert float((want[1] >= 0).float().mean()) > 0.02
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape[1:] == w.shape[1:]
        assert torch.equal(g, w.expand_as(g))


@pytest.mark.gpu
def test_swar_kernel_matches_plain_version(cuda):
    """K4 at a million rows (indices below 0 and past the pool, weights
    at their rounding edges), bit for bit."""
    rng = np.random.default_rng(4)
    npool, n = 5461, 1 << 20
    pool = torch.from_numpy(rng.integers(0, 2**32, (npool, 4),
                                         dtype=np.uint32).view(np.int32))
    idx = torch.from_numpy(rng.integers(-5, npool + 5, n).astype(np.int32))
    fx = torch.from_numpy(rng.random(n, dtype=np.float32))
    fy = torch.from_numpy(rng.random(n, dtype=np.float32))
    fx[:6] = torch.tensor([0.0, 1.0, 0.5 / 256, 255.5 / 256, -1.0, 2.0])
    args = [x.to(cuda) for x in (pool, idx, fx, fy)]
    before = td.bilin_swar.launches
    got = td.bilin_swar(*args)
    torch.cuda.synchronize()
    assert td.bilin_swar.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(
        got.cpu(), td.bilin_swar_reference(pool, idx, fx, fy))


@pytest.mark.gpu
def test_world_frame_on_card_matches_cpu(cuda):
    """A small archive world, mipmapped, from the tri pool: the palette
    computed on the card by ``bone_mats_device`` equals the host's bit
    for bit, and the frame on the card matches the CPU's (plain raster)
    under the golden rule with exact coverage."""
    kw = dict(buildings=16, width=W, height=H, characters=3, variants=4,
              terrain_subdiv=2, building_subdivs=(1, 2))
    out = {}
    for dev in ("cpu", cuda):
        case = entry.world_case(dev, **kw)
        # the reference's bird's-eye view of the character row
        case.camera.position = np.float32([0.0, -4 * 1.6 - 2.0, 9.0])
        case.camera.far = 120.0
        pal = (case.bone_mats_device(12.0) if dev == cuda
               else case.bone_mats(12.0))
        out[str(dev)] = pal, td.render_frame(
            case.scene, case.view_proj(), pal, width=W, height=H,
            mipmap=True, packed=True)
    tr.flush_overflow_checks()
    (gp, (gc, gd)), (wp, (wc, wd)) = out["cuda"], out["cpu"]
    assert gp.device.type == "cuda"
    assert torch.equal(gp.cpu(), torch.from_numpy(wp))
    assert torch.equal(gd.cpu() < 1.0, wd < 1.0)
    assert 0.05 < float((wd < 1.0).float().mean())
    diff = np.abs(td.unpack_rgba(gc).astype(np.int32)
                  - td.unpack_rgba(wc).astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.003


def _decoded_chains(batch):
    """Each texture's box-filter chain, every level BC1-encoded and
    decoded: the content a bc1 pool holds."""
    from mt_renderer_tpu_torch.render import bcn

    return [[bcn.decode_bc1_blocks_numpy(bcn.encode_bc1_numpy(img),
                                         img.shape[1], img.shape[0])
             for img in td.mip_chain(t)] for t in batch.textures]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["tri", "bc1", "bc7"])
def test_pool_build_on_card_matches_cpu(cuda, mode):
    """The tri, bc1 and bc7 pools built on the card equal the CPU's
    build, byte for byte, on a small world's mixed texture sizes."""
    kw = dict(buildings=8, width=W, height=H, characters=2, variants=4,
              terrain_subdiv=2, building_subdivs=(1,), pool_mode=mode)
    got = entry.world_case(cuda, **kw).scene
    want = entry.world_case("cpu", **kw).scene
    assert got.mip_pool.device.type == "cuda"
    assert torch.equal(got.mip_pool.cpu(), want.mip_pool)
    assert torch.equal(got.aux_pool.cpu(), want.aux_pool)
    assert td.pool_stats(got) == td.pool_stats(want)


@pytest.mark.gpu
def test_decode_bc1_device_on_card_matches_numpy(cuda):
    from mt_renderer_tpu_torch.render import bcn

    rng = np.random.default_rng(2)
    h, w = 37, 23
    blk = rng.integers(0, 256, (((h + 3) // 4) * ((w + 3) // 4), 8),
                       dtype=np.uint8)
    blk[::3, 7] |= 0x80
    got = bcn.decode_bc1_device(torch.from_numpy(blk.reshape(-1)), w, h,
                                device=cuda)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  bcn.decode_bc1_numpy(blk.tobytes(), w, h))


@pytest.mark.gpu
@pytest.mark.parametrize("peel", [0, 3])
def test_bc1_frame_on_card_equals_decoded_chains(cuda, peel):
    """The bc1 mip frame on the card (K1, and with ``peel`` K2 in the
    split peel, mtap) equals the frame of a quad pool of its decoded
    chains on the card, bit for bit, and the CPU's under the golden
    rule with exact coverage."""
    batch, vp, bones = _glass()
    out = {}
    for dev in (cuda, "cpu"):
        for name, scene in (
                ("bc1", td.upload(batch, "bc1", device=dev)),
                ("dec", td.upload(batch, device=dev,
                                  mip_chains=_decoded_chains(batch)))):
            kw = dict(width=W, height=H, packed=True, mipmap=True,
                      lighting=True)
            if peel:
                out[str(dev), name] = td.render_frame_peeled(
                    scene, vp, bones, layers=peel, peel_mode="split", **kw)
            else:
                out[str(dev), name] = td.render_frame(scene, vp, bones, **kw)
    tr.flush_overflow_checks()
    (gc, gd), (dc, dd) = out["cuda", "bc1"], out["cuda", "dec"]
    assert torch.equal(gc, dc) and torch.equal(gd, dd)
    wc, wd = out["cpu", "bc1"]
    assert torch.equal(gd.cpu() < 1.0, wd < 1.0)
    assert 0.05 < float((wd < 1.0).float().mean())
    diff = np.abs(td.unpack_rgba(gc).astype(np.int32)
                  - td.unpack_rgba(wc).astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.003


@pytest.mark.gpu
def test_narrow_frame_on_card_equals_quad(cuda):
    batch, vp, bones = _glass()
    kw = dict(width=W, height=H, packed=True, mipmap=True, lighting=True)
    quad = td.render_frame(td.upload(batch, device=cuda), vp, bones, **kw)
    narrow = td.render_frame(td.upload(batch, "narrow", device=cuda), vp,
                             bones, **kw)
    tr.flush_overflow_checks()
    assert torch.equal(quad[0], narrow[0]) and torch.equal(quad[1],
                                                           narrow[1])


@pytest.mark.gpu
def test_helpers_on_card(cuda):
    """``count_covered_textured`` launches K1 and equals the CPU's
    counts; ``pool_budget_default`` is 3/4 of the card's memory, and
    ``upload("auto", mipmap=True)`` picks the tri pool under it."""
    batch, vp, bones = _glass()
    before = tr.raster_fwd.launches
    got = td.count_covered_textured(td.upload(batch, device=cuda), vp,
                                    bones, width=W, height=H)
    assert tr.raster_fwd.launches == before + 1
    assert got[0].device.type == "cuda"
    want = td.count_covered_textured(td.upload(batch, device="cpu"), vp,
                                     bones, width=W, height=H)
    assert [int(x) for x in got] == [int(x) for x in want]
    total = torch.cuda.get_device_properties(cuda).total_memory
    if not os.environ.get("MTR_POOL_BUDGET_MB"):
        assert td.pool_budget_default(cuda) == total * 3 // 4
    assert td.upload(batch, "auto", device=cuda,
                     mipmap=True).pool_mode == "tri"


def _bc7_blocks(n: int, seed: int) -> np.ndarray:
    """(n, 16) random BC7 blocks of all eight modes, every third with
    bit 31 of word 3 set."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    m = rng.integers(0, 8, n)
    blk[:, 0] = ((1 << m) | ((blk[:, 0].astype(np.int64) << (m + 1))
                             & 0xFF)).astype(np.uint8)
    blk[::3, 15] |= 0x80
    return blk


def _bc7_content(batch, content: str):
    """(upload kwargs, decoded chains) of mode-6 content (the encoder at
    upload) or of random all-mode blocks (``bc7_chains``)."""
    from mt_renderer_tpu_torch.render import bcn

    kw, dec = {}, []
    chains = []
    for ti, t in enumerate(batch.textures):
        ch, dch = [], []
        for li, img in enumerate(td.mip_chain(t)):
            h, w = img.shape[:2]
            blk = (bcn.encode_bc7_mode6_numpy(img) if content == "mode6"
                   else _bc7_blocks(((h + 3) // 4) * ((w + 3) // 4),
                                    seed=31 * ti + li))
            ch.append((blk, h, w))
            dch.append(bcn.decode_bc7_numpy(blk.tobytes(), w, h))
        chains.append(ch)
        dec.append(dch)
    if content != "mode6":
        kw["bc7_chains"] = chains
    return kw, dec


@pytest.mark.gpu
def test_decode_bc7_on_card_matches_numpy(cuda):
    """The whole-level decode and the per-texel decode (with hints) on
    the card equal the NumPy decoder on blocks of all modes."""
    from mt_renderer_tpu_torch.render import bcn

    h, w = 37, 23
    blk = _bc7_blocks(((h + 3) // 4) * ((w + 3) // 4), seed=2)
    want = bcn.decode_bc7_numpy(blk.tobytes(), w, h)
    got = bcn.decode_bc7_device(torch.from_numpy(blk.reshape(-1)), w, h,
                                device=cuda)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    words = bcn.bc7_words(torch.from_numpy(blk).to(cuda)[:, None])
    hh = torch.from_numpy(bcn.bc7_block_hints(blk).astype(np.int64)).to(cuda)
    t = torch.arange(16, device=cuda)[None]
    tex = torch.stack(bcn.bc7_texel_device(words, t, hint=(hh[:, :1],
                                                          hh[:, 1:])), -1)
    n = len(blk)
    flat = bcn.decode_bc7_numpy(blk.tobytes(), 4 * n, 4)
    np.testing.assert_array_equal(
        tex.cpu().numpy(),
        flat.reshape(4, n, 4, 4).transpose(1, 0, 2, 3).reshape(n, 16, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("content", ["mode6", "all_modes"])
@pytest.mark.parametrize("peel", [0, 3])
def test_bc7_frame_on_card_equals_decoded_chains(cuda, content, peel):
    """The bc7 mip frame on the card (K1, and with ``peel`` K2 in the
    split peel, mtap + lit) equals the frame of a quad pool of its
    decoded chains (with the bc7 scene's opacity flags) on the card, bit
    for bit, and the CPU's under the golden rule with exact coverage."""
    import dataclasses

    batch, vp, bones = _glass()
    kw_up, dec = _bc7_content(batch, content)
    out = {}
    for dev in (cuda, "cpu"):
        bc7 = td.upload(batch, "bc7", device=dev, **kw_up)
        # mode 6 rounds some of the opaque texture's alpha to 254, which
        # flags the decoded chains translucent; the bc7 pool keeps the
        # source texture's flag (as the reference does): hold the texels
        ref = td.upload(batch, device=dev, mip_chains=dec)
        ref = dataclasses.replace(ref, cols_const=torch.cat(
            [ref.cols_const[:9], bc7.cols_const[9:]]))
        for name, scene in (("bc7", bc7), ("dec", ref)):
            kw = dict(width=W, height=H, packed=True, mipmap=True,
                      lighting=True)
            if peel:
                out[str(dev), name] = td.render_frame_peeled(
                    scene, vp, bones, layers=peel, peel_mode="split", **kw)
            else:
                out[str(dev), name] = td.render_frame(scene, vp, bones, **kw)
    tr.flush_overflow_checks()
    (gc, gd), (dc, dd) = out["cuda", "bc7"], out["cuda", "dec"]
    assert torch.equal(gc, dc) and torch.equal(gd, dd)
    wc, wd = out["cpu", "bc7"]
    assert torch.equal(gd.cpu() < 1.0, wd < 1.0)
    assert 0.05 < float((wd < 1.0).float().mean())
    diff = np.abs(td.unpack_rgba(gc).astype(np.int32)
                  - td.unpack_rgba(wc).astype(np.int32)).max(-1)
    assert (diff > 1).mean() <= 0.003


@pytest.mark.gpu
def test_bc7_world_frame_on_card_equals_decoded_chains(cuda):
    """A small world from ``entry.world_case(pool_mode="bc7")`` on the
    card: mode-6 content, its frame equal to a tri pool of its decoded
    chains bit for bit."""
    case = entry.world_case(cuda, buildings=8, width=W, height=H,
                            characters=2, variants=4, terrain_subdiv=2,
                            building_subdivs=(1,), pool_mode="bc7")
    _, dec = _bc7_content(case.batch, "mode6")
    ref = td.upload(case.batch, "tri", device=cuda, mip_chains=dec)
    pal = case.bone_mats_device(6.0)
    kw = dict(width=W, height=H, packed=True, mipmap=True)
    got, gd = td.render_frame(case.scene, case.view_proj(), pal, **kw)
    want, wd = td.render_frame(ref, case.view_proj(), pal, **kw)
    tr.flush_overflow_checks()
    assert case.scene.bc7_modes == (6,)
    assert torch.equal(got, want) and torch.equal(gd, wd)
    assert bool((wd < 1.0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("case", bc7_taps.CASES)
def test_bc7_trilinear_kernel_matches_plain_version(cuda, case):
    """The bc7 trilinear kernel (``csrc/bc7_trilinear.cu``, one launch
    through ``mtr::bc7_trilinear``) equals its plain twin on the card and
    on the CPU bit for bit, on ``bc7_taps``' cases; under a profiler it
    counts its taps in ``bc7.kernel_taps``."""
    sc, modes = bc7_taps.scene(case, cuda)
    taps = bc7_taps.taps(sc, n=4096)
    launches = td.bc7_trilinear.launches
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = torch.stack(td._trilinear_arith(
            sc.mip_pool, *taps, sc.num_mips, mode="bc7", aux=sc.aux_pool,
            bc7_modes=modes))
    torch.cuda.synchronize()
    assert td.bc7_trilinear.launches == launches + 1
    assert profiling.count_totals() == {"bc7.kernel_taps": taps[0].numel()}
    profiling.reset_spans()
    aux = sc.aux_pool if td._bc7_needs_hint(modes) else None
    want = td.bc7_trilinear_reference(sc.mip_pool, aux, *taps, sc.num_mips,
                                      modes)
    assert got.device.type == "cuda" and torch.equal(got, want)
    cpu, _ = bc7_taps.scene(case, "cpu")
    assert torch.equal(got.cpu(), bc7_taps.twin(
        cpu, modes, *(x.cpu() for x in taps)))


def _all_mode_bc7_world(dev):
    """A small world on the bc7 pool, every texture's chain random blocks
    of all eight modes (``bc7_taps.blocks``) → (case, scene)."""
    case = entry.world_case(dev, buildings=8, width=W, height=H,
                            characters=2, variants=4, terrain_subdiv=2,
                            building_subdivs=(1,), pool_mode="quad")
    chains = [[(bc7_taps.blocks(((h + 3) // 4) * ((w + 3) // 4),
                                seed=31 * ti + li), h, w)
               for li, (h, w) in enumerate(
                   img.shape[:2] for img in td.mip_chain(t))]
              for ti, t in enumerate(case.batch.textures)]
    scene = td.upload(case.batch, "bc7", device=dev, bc7_chains=chains)
    assert scene.bc7_modes == tuple(range(8))
    return case, scene


@pytest.mark.gpu
def test_bc7_frame_engine_shades_through_the_kernel(cuda):
    """A small all-mode bc7 world through ``FrameEngine(mipmap=True)``:
    every frame's compacted shade launches the bc7 kernel, and the frame
    equals ``render_frame``'s at the engine's caps."""
    from mt_renderer_tpu_torch.render import engine as en

    case, scene = _all_mode_bc7_world(cuda)
    eng = en.FrameEngine(scene, case.batch, width=W, height=H, mipmap=True)
    for t in range(3):
        case.camera.yaw += 4.0
        vp, pal = case.view_proj(), case.bone_mats_device(2.0 * t)
        before = td.bc7_trilinear.launches
        color, depth = eng.render(vp, pal)
        assert td.bc7_trilinear.launches > before
        want, wdepth = td.render_frame(
            scene, vp, pal, width=W, height=H, packed=True, mipmap=True,
            maxc=eng.maxc, tap_tiles=eng.tap_tiles)
        assert torch.equal(color, want) and torch.equal(depth, wdepth)
    eng.check()
    tr.flush_overflow_checks()


@pytest.mark.gpu
def test_bench_legs_on_card(cuda):
    """Every verify leg of the reference bench passes on the card at its
    size (256x256, 9 instances at subdiv 2), through K1 and K2."""
    from mt_renderer_tpu_torch import verify

    k1, k2 = tr.raster_fwd.launches, tr.raster_fwd_ml.launches
    r = verify.bench_legs(cuda)
    assert r["passed"], r
    assert tr.raster_fwd.launches > k1 and tr.raster_fwd_ml.launches > k2


# ------------------------------------------------------------- viewers


def _gui_case(rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    band = rng.integers(0, 256, (rows, W, 4), dtype=np.uint8)
    for i, a in enumerate((0, 1, 127, 128, 254, 255)):
        frame[i::7, :, 3] = a
        band[:, i::7, 3] = a
    return frame, band


@pytest.mark.gpu
@pytest.mark.parametrize("rows,y0", [(H, 0), (24, 0), (24, 50)])
def test_gui_composite_on_card_matches_cpu(cuda, rows, y0):
    """The HUD composite (torch ops) gives the CPU's bits on the card,
    packed and unpacked."""
    from mt_renderer_tpu_torch.scene import gui

    frame, band = _gui_case(rows, seed=rows + y0)
    fp = torch.from_numpy(frame.copy().view(np.int32)[..., 0])
    bp = torch.from_numpy(band.copy().view(np.int32)[..., 0])
    want = gui._composite_packed(fp, bp, y0=y0)
    got = gui._composite_packed(fp.to(cuda), bp.to(cuda), y0=y0)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    want = gui._composite_u8(torch.from_numpy(frame), bp, y0=y0)
    got = gui._composite_u8(torch.from_numpy(frame).to(cuda), bp.to(cuda),
                            y0=y0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("tex_shape,size", [((64, 64), (96, 80)),
                                            ((16, 40), (72, 64)),
                                            ((48, 12), (64, 80)),
                                            ((5, 7), (96, 64)),
                                            ((512, 256), (200, 120))])
@pytest.mark.parametrize("ycbcr", [False, True])
def test_view_texture_on_card_matches_cpu(cuda, tex_shape, size, ycbcr):
    """The texture view gives the CPU's bits on the card (no division by
    a host scalar, which CUDA turns into a reciprocal product)."""
    from mt_renderer_tpu_torch.render.texture_view import view_texture

    tex = np.random.default_rng(sum(tex_shape)).integers(
        0, 256, (*tex_shape, 4), dtype=np.uint8)
    w, h = size
    want = view_texture(torch.from_numpy(tex), width=w, height=h,
                        ycbcr=ycbcr)
    got = view_texture(torch.from_numpy(tex).to(cuda), width=w, height=h,
                       ycbcr=ycbcr)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_modelviewer_demo_on_card(cuda, tmp_path):
    """``modelviewer --demo`` on the card at 256x256 with the HUD: K1 in
    every frame, no overflow, and the engine's frame 0 under the golden
    rule against the same frame rendered on the CPU."""
    from mt_renderer_tpu_torch.cli import modelviewer
    from mt_renderer_tpu_torch.render import engine as te

    seen = []
    orig_render, orig_counts = te.FrameEngine.render, tr.flush_overflow_counts

    def render(self, vp, bones=None):
        k1 = tr.raster_fwd.launches
        color, depth = orig_render(self, vp, bones)
        seen.append((tr.raster_fwd.launches - k1, np.asarray(vp),
                     bones.cpu() if isinstance(bones, torch.Tensor)
                     else bones, color.cpu()))
        return color, depth

    over = []

    def counts():
        c = orig_counts()
        over.extend(n for n, _ in c.values() if n > 0)
        return c

    te.FrameEngine.render, tr.flush_overflow_counts = render, counts
    try:
        mgr = modelviewer.main(["--demo", "6", "--frames", "4", "--width",
                                "256", "--height", "256", "--hud", "--out",
                                str(tmp_path / "f_{i}.png")])
    finally:
        te.FrameEngine.render, tr.flush_overflow_counts = (orig_render,
                                                           orig_counts)
    tr.flush_overflow_checks()
    assert mgr.frame_index == 4 and len(seen) == 4
    assert all(n >= 1 for n, *_ in seen), [n for n, *_ in seen]
    assert not over and mgr.app._eng.recoveries == 0
    _, vp, bones, color = seen[0]
    app = mgr.app
    cpu = td.upload(app.world.batch, pool_mode="auto", mipmap=True,
                    device="cpu")
    eng = te.FrameEngine(cpu, app.world.batch, width=256, height=256,
                         mipmap=True)
    want, _ = eng.render(vp, bones)
    got, want = td.unpack_rgba(color), td.unpack_rgba(want)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max(-1)
    assert float((diff > 1).mean()) <= 0.003


@pytest.mark.gpu
@pytest.mark.parametrize("mipmap", [False, True])
def test_served_headline_on_card_equals_render_frame(cuda, mipmap):
    """The headline scene (1024 instances at subdiv 4) at 256x256 served
    from ``export_render``'s program on the card: every request equals
    ``render_frame`` bit for bit, K1 launches once a request through its
    op, and the queue holds no overflow."""
    from mt_renderer_tpu_torch import serving

    case = entry.demo_case(cuda, instances=1024, subdiv=4, width=256,
                           height=256, pool_mode="tri" if mipmap else "quad")
    art = serving.load_render(serving.export_render(
        case.scene, width=256, height=256, mipmap=mipmap,
        platforms=["cuda"]))
    assert art.device.type == "cuda"
    tr.flush_overflow_counts()
    for t in range(3):
        case.camera.yaw += 5.0
        vp, bones = case.view_proj(), case.bone_mats(0.3 * t)
        k1 = tr.raster_fwd.launches
        color, depth = art(case.scene, vp, bones)
        assert tr.raster_fwd.launches == k1 + 1
        want, wdepth = td.render_frame(case.scene, vp, bones, width=256,
                                       height=256, mipmap=mipmap)
        assert color.device.type == "cuda"
        assert torch.equal(color, want) and torch.equal(depth, wdepth)
    assert all(n == 0 for n, _ in tr.flush_overflow_counts().values())


@pytest.mark.gpu
@pytest.mark.parametrize("mipmap", [False, True])
def test_served_graph_replays_equal_render_frame(cuda, mipmap):
    """The served artifact on the card as one CUDA graph: the headline
    scene (quad pool) and, mipmapped, on the tri pool, at 256x256. Six
    requests on scene A (the first eager, the second captures, then
    replays), three on scene B (A with every other triangle left out: a
    leaf at another address), one on A again (eager: the graph is B's).
    Every request equals ``render_frame`` bit for bit, launches K1 once
    and queues its two overflow counts, equal to the eager frame's; a
    frame held from one request is unchanged after the next; under a
    profiler ``serve.replays`` counts the requests less the three eager
    ones and ``serve.captures`` the two captures. A palette of another
    shape raises, as the program does."""
    import dataclasses

    from mt_renderer_tpu_torch import serving

    case = entry.demo_case(cuda, instances=1024, subdiv=4, width=256,
                           height=256, pool_mode="tri" if mipmap else "quad")
    a = case.scene
    keep = (torch.arange(a.tri_vis.shape[0], device=cuda) % 2 == 0)
    b = dataclasses.replace(a, tri_vis=a.tri_vis & keep)
    art = serving.load_render(serving.export_render(
        a, width=256, height=256, mipmap=mipmap, platforms=["cuda"]))
    tr.flush_overflow_counts()
    plan = [a] * 6 + [b] * 3 + [a]
    held, queued = None, []
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for i, scene in enumerate(plan):
            case.camera.yaw += 7.0
            vp, bones = case.view_proj(), case.bone_mats(0.2 * i)
            k1 = tr.raster_fwd.launches
            color, depth = art(scene, vp, bones)
            assert tr.raster_fwd.launches == k1 + 1, i
            assert sorted(len(q) for q in tr._PENDING.values()) == [i + 1] * 2
            got = sorted((w, q[-1]) for w, q in tr._PENDING.items())
            want, wdepth = td.render_frame(scene, vp, bones, width=256,
                                           height=256, mipmap=mipmap,
                                           check_overflow=False)
            assert torch.equal(color, want) and torch.equal(depth, wdepth), i
            if held is not None:
                assert torch.equal(held[0], held[1]), i
            held = (color, color.clone())
            n_over = td._render_frame_core(
                scene, vp, bones, width=256, height=256,
                clear_color=(255, 255, 255, 255), maxc=None, tap_tiles=None,
                mipmap=mipmap)[2]
            queued.append(([x for _, x in got], [int(n) for n in n_over]))
    assert art._graph is not None and art._graph.key == serving._call_key(
        serving.scene_leaves(b), vp, bones)
    # each request's pair, read after the last: no replay overwrote one
    for i, (pair, want) in enumerate(queued):
        assert sorted(int(x) for x in pair) == sorted(want), i
    assert all(n == 0 for n, _ in tr.flush_overflow_counts().values())
    calls = profiling.count_totals()
    assert calls.get("serve.replays") == len(plan) - 3
    assert calls.get("serve.captures") == 2
    assert profiling.span_totals()["serve.capture"][0] == 2
    profiling.reset_spans()
    # a palette of another shape runs the program, which refuses it
    with pytest.raises(RuntimeError, match="shape"):
        art(b, vp, bones[:1])


@pytest.mark.gpu
def test_served_scan_artifact_on_card_stays_eager(cuda):
    """The scan backend's artifact (its chunk loop unrolled; here on a
    bc1 pool, which the binned raster refuses unmipmapped) on the card:
    its program copies host constants to the device, which a CUDA graph's
    capture refuses, so it never captures; four requests, each equal to
    ``render_frame(backend="scan")`` bit for bit."""
    from mt_renderer_tpu_torch import serving

    case = entry.demo_case(cuda, instances=4, subdiv=1, width=64,
                           height=64, pool_mode="bc1")
    art = serving.load_render(serving.export_render(
        case.scene, width=64, height=64, backend="scan"))
    assert art.meta["backend"] == "scan"
    for i in range(4):
        case.camera.yaw += 3.0
        vp, bones = case.view_proj(), case.bone_mats(0.3 * i)
        got = art(case.scene, vp, bones)
        want = td.render_frame(case.scene, vp, bones, width=64, height=64,
                               backend="scan")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool((want[1] < 1.0).any())
    assert art._graph is None
    tr.flush_overflow_checks()


@pytest.mark.gpu
def test_served_bc7_world_replays_its_graph(cuda):
    """A small world on the bc7 pool with blocks of all eight modes (the
    ``world_bc7`` configuration's pool) served from ``export_render``'s
    program on the card: the first call is eager, the second captures
    and replays, the third and fourth replay. On the same inputs every
    replay equals the eager call's frame bit for bit, and on a new view
    ``render_frame``'s; each call advances ``bc7_trilinear.launches`` by
    one and, under a profiler, ``bc7.kernel_taps`` by the eager call's
    taps."""
    from mt_renderer_tpu_torch import serving

    case, scene = _all_mode_bc7_world(cuda)
    art = serving.load_render(serving.export_render(
        scene, width=W, height=H, mipmap=True, platforms=["cuda"]))
    tr.flush_overflow_counts()
    vp, pal = case.view_proj(), case.bone_mats_device(2.0)
    frames, launched, taps = [], [], []
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(4):
            before = td.bc7_trilinear.launches
            t0 = profiling.count_totals().get("bc7.kernel_taps", 0)
            frames.append(art(scene, vp, pal))
            launched.append(td.bc7_trilinear.launches - before)
            taps.append(profiling.count_totals()["bc7.kernel_taps"] - t0)
        counts = profiling.count_totals()
    profiling.reset_spans()
    assert counts.get("serve.captures") == 1
    assert counts.get("serve.replays") == 3
    assert launched == [1] * 4 and taps == [taps[0]] * 4 and taps[0] > 0
    color, depth = frames[0]
    assert bool((depth < 1.0).any())
    for got, gdepth in frames[1:]:
        assert torch.equal(got, color) and torch.equal(gdepth, depth)
    case.camera.yaw += 9.0
    vp, pal = case.view_proj(), case.bone_mats_device(3.0)
    got, gdepth = art(scene, vp, pal)
    want, wdepth = td.render_frame(scene, vp, pal, width=W, height=H,
                                   mipmap=True, check_overflow=False)
    assert torch.equal(got, want) and torch.equal(gdepth, wdepth)
    assert art._graph is not None
    assert all(n == 0 for n, _ in tr.flush_overflow_counts().values())


@pytest.mark.gpu
def test_headline_orbit_guard_on_card(cuda):
    """The headline scene (1024 instances at subdiv 4) at 1920x1080
    through ``FrameEngine(interactive=True)`` for 20 frames of an orbit:
    the guard's bin need on the card equals ``bin_chunks``' count on the
    frame's own boxes, no overflow is queued, and every frame equals
    ``render_frame`` at the engine's caps bit for bit."""
    from mt_renderer_tpu_torch.render import engine as te

    w, h = 1920, 1080
    case = entry.demo_case(cuda, instances=1024, subdiv=4, width=w,
                           height=h)
    eng = te.FrameEngine(case.scene, case.batch, width=w, height=h,
                         interactive=True)
    over = []
    check = eng.check

    def counted(*a, **k):
        counts = check(*a, **k)
        over.extend(n for n, _ in counts.values() if n > 0)
        return counts

    eng.check = counted
    pw, ph = td._padded(w, h)
    for t in range(20):
        case.camera.yaw += 1.5
        vp, bones = case.view_proj(), case.bone_mats(t / 60.0)
        got, got_d = eng.render(vp, bones)
        want, want_d = td.render_frame(case.scene, vp, bones, width=w,
                                       height=h, packed=True, maxc=eng.maxc,
                                       tap_tiles=eng.tap_tiles,
                                       check_overflow=False)
        assert got.device.type == "cuda"
        assert torch.equal(got, want) and torch.equal(got_d, want_d), t
        need = td.guard_counts(case.scene, vp, bones, width=w, height=h)
        clip = td.vertex_stage(case.scene, vp, bones)
        _, bbox = td.setup_packed_cols(case.scene, clip, w, h)
        counts_true = tr.bin_chunks(bbox, ph // tr.TILE_H, pw // tr.TILE_W,
                                    1, 0, 0)[3]
        assert int(need[0]) == int(counts_true.max()) <= eng.maxc
    assert over == []


@pytest.mark.gpu
@pytest.mark.parametrize("mode", tr.MODES)
@pytest.mark.parametrize("lit", [False, True])
def test_k1_ops_pass_opcheck_on_card(cuda, mode, lit):
    (cols, lists, glists, counts, _), _ = _binned(
        cuda, glass="all" if lit else None, lighting=lit)
    light = list(td._light_unit()) if lit else None
    torch.library.opcheck(tr.K1_OPS[mode], (cols, lists, glists, counts,
                                            [0, 0], W, H, td.W_EPS, light))


@pytest.mark.gpu
def test_cpu_artifact_refuses_card_tensors(cuda):
    from mt_renderer_tpu_torch import serving

    case = entry.demo_case("cpu", instances=4, subdiv=1, width=128,
                           height=64)
    art = serving.load_render(serving.export_render(case.scene, width=128,
                                                    height=64))
    card = [x.to(cuda) for x in serving.scene_leaves(case.scene)]
    with pytest.raises(ValueError, match="is on cuda"):
        art(card, case.view_proj(), case.bone_mats(0.2))
    with pytest.raises(ValueError, match="holds the scene's device"):
        serving.export_render(case.scene, width=128, height=64,
                              platforms=["cuda"])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 8])
def test_band_and_geometry_splits_on_card_equal_single_frame(cuda, n):
    """The band split (packed, unpacked, the trilinear frame from the tri
    pool, the split peel) and the geometry split over n slots of the card
    equal the single-device frame on the card bit for bit, with K1
    launched once a band or shard (and K2 once a peeled band)."""
    from mt_renderer_tpu_torch.parallel import tiles

    mesh = tiles.make_row_mesh(n, device=cuda)
    case = entry.demo_case(cuda, instances=9, subdiv=2, width=W, height=120)
    tri = td.upload(case.batch, "tri", device=cuda)
    vp, bones = case.view_proj(), case.bone_mats(0.4)
    kw = dict(width=W, height=120)
    for scene, flags in ((case.scene, dict(packed=True)),
                         (case.scene, dict()),
                         (tri, dict(mipmap=True, lighting=True))):
        want = td.render_frame(scene, vp, bones, **kw, **flags)
        for split in (tiles.render_frame_multichip,
                      tiles.render_frame_geomsplit):
            before = tr.raster_fwd.launches
            got = split(scene, vp, bones, mesh=mesh, **kw, **flags)
            assert tr.raster_fwd.launches - before == n
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    batch, gvp, gbones = _glass(width=W, height=120)
    glass = td.upload(batch, device=cuda)
    want = td.render_frame_peeled(glass, gvp, gbones, layers=3,
                                  peel_mode="split", packed=True, **kw)
    before = tr.raster_fwd_ml.launches
    got = tiles.render_frame_multichip(glass, gvp, gbones, mesh=mesh,
                                       peel_layers=3, packed=True, **kw)
    assert tr.raster_fwd_ml.launches - before == n
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tr.flush_overflow_checks()
    assert not tr.OVERFLOW_EVENTS


@pytest.mark.gpu
def test_gloo_all_reduce_carries_card_bits(cuda, tmp_path):
    """A one-rank gloo group takes CUDA tensors in ``all_reduce``: the
    int32 view's SUM carries a -0.0 unchanged, and the band split over
    the group returns the card frame's rows."""
    import torch.distributed as dist

    from mt_renderer_tpu_torch.parallel import multihost, tiles

    multihost.init((tmp_path / "rdv").as_uri(), 1, 0)
    try:
        slots = tiles._Slots(td.upload(demo.build_demo_batch(instances=1),
                                       device=cuda), None,
                             multihost.global_row_mesh())
        part = torch.tensor([-0.0, 1.5], device=cuda)
        got = slots.gather_sum([part])
        assert got.device.type == "cuda" and bool(got.signbit()[0])
        assert slots.reduce([torch.tensor([3], dtype=torch.int32,
                                          device=cuda)], "min") == 3
        case = entry.demo_case(cuda, instances=4, width=64, height=64)
        vp, bones = case.view_proj(), case.bone_mats(0.5)
        color, depth = multihost.render_frame_multihost(
            case.scene, vp, bones, width=64, height=64, packed=True)
        want, wdepth = td.render_frame(case.scene, vp, bones, width=64,
                                       height=64, packed=True)
        assert color.row0 == 0 and torch.equal(color.rows, want)
        full = multihost.gather_full_frame(depth, 64)
        np.testing.assert_array_equal(full, wdepth.cpu().numpy())
    finally:
        dist.destroy_process_group()
