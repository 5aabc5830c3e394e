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
world, computed on the card, equals the host's bit for bit.
"""

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.app.camera import Camera
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.scene import demo
from mt_renderer_tpu_torch.scene.model import DrawBatch
from test_torch_k1_cull import adversarial_cols, heavy_tile_case

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
