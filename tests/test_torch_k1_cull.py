"""K1's per-warp triangle cull: its plain twin against the per-pixel test.

K1 (``csrc/raster_fwd.cu``) culls every staged 32-triangle group against
each warp's 32x8 rectangle of pixel centers and evaluates only the
survivors. ``raster.warp_cull_reference`` is that cull op for op. The
winners stay those of the full evaluation only if the cull never rejects
a (triangle, warp) pair in which ``raster_fwd_reference``'s per-pixel
edge test (a*x + b*y + c > bias on all three edges, evaluated in f32 with
separate roundings) passes at some pixel: that is what these tests hold,
exactly (no tolerance), on seeded scenes (the demo, both sets of the
glass scene's opacity split, a small world, a heavy tile) and on
adversarial setups: edges through pixel centers, top-left ties, slivers,
REJECT rows whose edge values overflow to +inf, coefficients of clipped
triangles near W_EPS, NaN and inf coefficients, and z = -0.0.

The kernel itself is held against ``raster_fwd_reference`` on the card
(``tests/test_torch_gpu.py``, on these same scenes). No jax here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.scene import demo
from mt_renderer_tpu_torch.tools import raster_roofline
from torch_threads import one_thread  # noqa: F401

W, H = 256, 128


def _edges(sx, sy, width, height):
    """``device.setup_packed_cols``' edge and bias math on screen-space
    vertices sx, sy (3, T) f32 → (ea, eb, ec, bias) lists of 3 (T,) f32,
    with REJECT where the triangle is back-facing or degenerate."""
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (
        sx[2] - sx[0])
    valid = area2 < 0.0
    ea, eb, ec, bias = [], [], [], []
    for i in range(3):
        ax, ay = sx[(i + 1) % 3], sy[(i + 1) % 3]
        bx, by = sx[(i + 2) % 3], sy[(i + 2) % 3]
        a = by - ay
        b = -(bx - ax)
        c = ay * (bx - ax) - ax * (by - ay)
        topleft = ((ay == by) & (bx < ax)) | (by > ay)
        snap = 1e-6 * (a.abs() * width + b.abs() * height + c.abs())
        bi = torch.where(topleft, -snap * 1.000001, snap)
        ea.append(a)
        eb.append(b)
        ec.append(c)
        bias.append(torch.where(valid, bi, tr.REJECT))
    return ea, eb, ec, bias


def adversarial_cols(seed: int = 0, width: int = W, height: int = H):
    """A seeded (33, Tp) setup matrix of triangles chosen to stress the
    cull, with every chunk listed in every tile → (cols, lists, glists,
    counts)."""
    rng = np.random.default_rng(seed)
    vx, vy = [], []

    def tri(*pts):
        vx.append([p[0] for p in pts])
        vy.append([p[1] for p in pts])

    for _ in range(96):          # vertices on pixel centers, both windings
        pts = rng.integers(0, [width, height], (3, 2)) + 0.5
        tri(*pts)
    for _ in range(24):          # quads split on a diagonal: shared edges
        x0, y0 = rng.integers(0, [width - 40, height - 40]) + 0.5
        s = float(rng.integers(1, 40))
        tri((x0, y0), (x0 + s, y0), (x0, y0 + s))
        tri((x0 + s, y0), (x0 + s, y0 + s), (x0, y0 + s))
        tri((x0, y0), (x0, y0 + s), (x0 + s, y0))        # back-facing twin
    for _ in range(48):          # slivers along pixel-center rows
        x0 = float(rng.integers(0, width - 64)) + 0.5
        y = float(rng.integers(0, height)) + 0.5
        d = float(rng.choice([0.0, 1e-6, 1e-3, 0.49, 0.5]))
        tri((x0, y), (x0 + 63.0, y + d), (x0 + 63.0, y - d))
        tri((x0, y), (x0 + 63.0, y - d), (x0 + 63.0, y + d))
    for _ in range(32):          # clipped: vertices out near 1/W_EPS
        big = 10.0 ** rng.uniform(6, 12)
        p = rng.uniform(-1, 1, (3, 2)) * [big, big]
        p[0] = rng.uniform(0, [width, height])
        tri(*p)
    sx = torch.tensor(np.asarray(vx, np.float32).T.copy())
    sy = torch.tensor(np.asarray(vy, np.float32).T.copy())
    ea, eb, ec, bias = _edges(sx, sy, width, height)
    t = sx.shape[1]
    z = [torch.from_numpy(rng.uniform(0.0, 1.0, t).astype(np.float32))
         * 1e-3 for _ in range(2)]
    z.append(torch.from_numpy(rng.uniform(0.05, 0.95, t).astype(np.float32)))
    cols = torch.stack(ea + eb + ec + bias + z, 0)

    def row(a, b, c, bi, zc=0.99):
        return torch.tensor([a[0], a[1], a[2], b[0], b[1], b[2], c[0], c[1],
                             c[2], bi[0], bi[1], bi[2], 0.0, 0.0, zc],
                            dtype=torch.float32)[:, None]

    inf, nan, rej = float("inf"), float("nan"), tr.REJECT
    full = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
            (0.0, 0.0, 0.0))                               # covers all
    left = row((-1.0, 0.0, 0.0), (0.0, 0.0, 0.0), (60.0, 1.0, 1.0),
               (0.0, 0.0, 0.0))                            # x < 60
    extra = [
        # REJECT rows whose edge values overflow to +inf: they pass
        row((1e37, 1e37, 1e37), (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
            (rej, rej, rej)),
        row((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (inf, inf, inf),
            (rej, rej, rej)),
        row((3e36, -3e36, 0.0), (0.0, 0.0, 0.0), (0.0, 3.3e38, 1.0),
            (rej, rej, 0.0)),
        # REJECT rows of ordinary size: nowhere inside
        row((1.0, -1.0, 0.0), (0.0, 1.0, -1.0), (10.0, 10.0, 10.0),
            (rej, rej, rej)),
        # NaN and inf coefficients
        row((nan, 0.0, 0.0), *full[1:]),
        row((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (nan, 1.0, 1.0),
            (0.0, 0.0, 0.0)),
        row((inf, 0.0, 0.0), *full[1:]),
        row((-inf, 0.0, 0.0), *full[1:]),
        row((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
            (-inf, nan, -1.0)),
        # an edge through a column of pixel centers, x > 100.5 and x <
        # 100.5, with the bias exactly at the centers' value
        row((1.0, -1.0, 0.0), (0.0, 0.0, 0.0), (-100.5, 100.5, 1.0),
            (0.0, 0.0, 0.0)),
        row((1.0, -1.0, 0.0), (0.0, 0.0, 0.0), (-100.5, 100.5, 1.0),
            (-1e-30, -1e-30, 0.0)),
        # the same through a row of centers, with a subnormal slope
        row((0.0, 0.0, 1e-40), (1.0, -1.0, 0.0), (-40.5, 40.5, 0.0),
            (0.0, -0.0, -1e-45)),
        # z = -0.0 and +0.0 left of x = 60: ties, the later id wins
        torch.cat([left[:12], torch.full((3, 1), -0.0)]),
        torch.cat([left[:12], torch.zeros((3, 1))]),
    ]
    cols = torch.cat([cols] + extra, 1)
    tp = -(-cols.shape[1] // tr.CT) * tr.CT
    pad = torch.zeros((tr.N_RAST, tp - cols.shape[1]))
    pad[9:12] = tr.REJECT
    cols = torch.cat([cols, pad], 1)
    coef = torch.from_numpy(rng.uniform(0.0, 1.0, (tr.N_COEF, tp)).astype(
        np.float32))
    coef[9] = torch.from_numpy(rng.integers(-1, 3, tp).astype(np.float32))
    coef[14:16] = 0.0
    coef[16:18] = 8.0
    cols = torch.cat([cols, coef], 0).contiguous()
    n_tiles = (width // tr.TILE_W) * (height // tr.TILE_H)
    n_chunks = tp // tr.CT
    lists = torch.arange(n_chunks, dtype=torch.int32)[None].repeat(n_tiles, 1)
    glists = torch.full_like(lists, (1 << tr.G) - 1)
    counts = torch.full((n_tiles,), n_chunks, dtype=torch.int32)
    return cols, lists, glists, counts


def heavy_tile_case(device="cpu"):
    """256 demo instances at subdiv 2 (12,288 triangles) framed into a
    256x32 band of four tiles, maxc sized by ``auto_maxc``: a long list
    per tile → the raster's positional arguments and keywords."""
    w, h = 256, 32
    batch = demo.build_demo_batch(instances=256, skinned=True, subdiv=2)
    vp = np.asarray(demo.demo_camera(256, w, h).view_proj())
    bones = demo.demo_bone_mats(0.5)
    maxc = td.auto_maxc(batch, vp, bones, width=w, height=h)
    scene = td.upload(batch, device=device)
    cols, bbox = td.setup_packed_cols(scene, td.vertex_stage(scene, vp,
                                                             bones), w, h)
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=w,
                                         height=h, maxc=maxc)
    return (cols, lists, glists, counts, (0, 0)), dict(width=w, height=h)


def _scene_args(kind: str):
    """A seeded scene's raster arguments and keywords."""
    if kind == "adversarial":
        return (*adversarial_cols(), (0, 0)), dict(width=W, height=H)
    if kind == "heavy":
        return heavy_tile_case()
    if kind == "world":
        case = entry.world_case("cpu", buildings=16, width=W, height=H,
                                characters=3, variants=4, terrain_subdiv=2,
                                building_subdivs=(1, 2))
        case.camera.position = np.float32([0.0, -4 * 1.6 - 2.0, 9.0])
        case.camera.far = 120.0
        scene, vp, bones = case.scene, case.view_proj(), case.bone_mats(12.0)
        batch = case.batch
    else:
        batch = demo.build_demo_batch(instances=16, skinned=True, subdiv=2)
        cam = demo.demo_camera(16, W, H)
        if kind != "demo":
            batch = demo.make_translucent(batch, 16)
            cam.position = cam.position * 0.3
        vp, bones = np.asarray(cam.view_proj()), demo.demo_bone_mats(0.5)
        scene = td.upload(batch, device="cpu")
    clip = td.vertex_stage(scene, vp, bones)
    if kind in ("glass_opaque", "glass_translucent"):
        setup = td.setup_packed_cols(scene, clip, W, H, opacity_split=True)
        cols, bbox = setup[kind == "glass_translucent"]
    else:
        cols, bbox = td.setup_packed_cols(scene, clip, W, H)
    maxc = td.auto_maxc(batch, vp, bones, width=W, height=H)
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=W,
                                         height=H, maxc=maxc)
    return (cols, lists, glists, counts, (0, 0)), dict(width=W, height=H)


def pixel_hits(cols, lists, glists, counts, origin, *, width, height):
    """The per-pixel test of ``raster_fwd_reference`` (all three edges
    e > bias, e = a*x + b*y + c in f32), reduced over each warp's pixels
    → (n_tiles, maxc, G, WARPS, KG) bool, the cull twin's shape."""
    px, py = tr.warp_pixel_centers(width, height, origin, cols.device)
    n_tiles, maxc = lists.shape
    hit = torch.zeros((n_tiles, maxc, tr.G, tr.WARPS, tr.KG),
                      dtype=torch.bool)
    kk = torch.arange(tr.KG)
    for s in range(int(counts.max())):
        for g in range(tr.G):
            act = torch.nonzero((counts > s)
                                & (((glists[:, s] >> g) & 1) != 0)).squeeze(1)
            if act.numel() == 0:
                continue
            ids = (lists[act, s, None].long() * tr.CT + g * tr.KG + kk)
            r = cols[:12][:, ids][:, :, None, :, None]   # (12, A, 1, KG, 1)
            x = px[act][:, :, None, :]                   # (A, WARPS, 1, 256)
            y = py[act][:, :, None, :]
            inside = ((r[0] * x + r[3] * y + r[6] > r[9])
                      & (r[1] * x + r[4] * y + r[7] > r[10])
                      & (r[2] * x + r[5] * y + r[8] > r[11]))
            hit[act, s, g] = inside.any(-1)
    return hit


@pytest.mark.parametrize("kind", ["demo", "glass_opaque",
                                  "glass_translucent", "world", "heavy",
                                  "adversarial"])
def test_cull_never_rejects_a_covering_pair(kind):
    """Every (triangle, warp) pair with a pixel inside all three edges
    survives the cull; and the cull does cut the binned work."""
    args, kw = _scene_args(kind)
    live = tr.warp_cull_reference(*args, **kw)
    hit = pixel_hits(*args, **kw)
    assert live.shape == hit.shape
    assert int(hit.sum()) > 0
    assert not bool((hit & ~live).any())
    cols, lists, glists, counts = args[:4]
    pairs = int(raster_roofline.tile_pairs(lists, glists, counts).sum())
    assert int(live.sum()) < 0.8 * pairs * tr.WARPS * tr.KG


@pytest.mark.parametrize("kind", ["demo", "adversarial"])
def test_cull_is_exact_per_edge(kind):
    """Edge by edge, the corner test passes exactly where some pixel
    center of the warp passes (or the corner value is NaN): the corner
    is a pixel center and every rounding of a*x + b*y + c is monotone."""
    args, kw = _scene_args(kind)
    cols = args[0]
    px, py = tr.warp_pixel_centers(kw["width"], kw["height"], (0, 0), "cpu")
    r = cols[:12, :, None, None, None]              # (12, Tp, 1, 1, 1)
    x, y = px[None], py[None]                      # (1, tiles, WARPS, 256)
    x0, x1 = px.amin(-1)[None], px.amax(-1)[None]  # (1, tiles, WARPS)
    y0, y1 = py.amin(-1)[None], py.amax(-1)[None]
    for e in range(3):
        a, b, c, bias = r[e], r[3 + e], r[6 + e], r[9 + e]
        hit = (a * x + b * y + c > bias).any(-1)
        corner = tr._edge_may_pass(a[..., 0], b[..., 0], c[..., 0],
                                   bias[..., 0], x0, x1, y0, y1)
        m = a[..., 0] * torch.where(a[..., 0] >= 0, x1, x0) + b[..., 0] * \
            torch.where(b[..., 0] >= 0, y1, y0) + c[..., 0]
        assert torch.equal(corner, hit | m.isnan() | bias[..., 0].isnan())


def test_adversarial_rows_survive_where_they_pass():
    """The rows built to break a careless cull: the REJECT rows that
    overflow to +inf pass the per-pixel test somewhere and survive; the
    ordinary REJECT row and the NaN rows pass nowhere; the
    exactly-on-center edges keep the warps whose centers pass."""
    args, kw = _scene_args("adversarial")
    cols = args[0]
    live = tr.warp_cull_reference(*args, **kw)
    hit = pixel_hits(*args, **kw)

    def by_id(x, i):          # (tiles, WARPS) of triangle id i (slot = chunk)
        return x[:, i // tr.CT, (i % tr.CT) // tr.KG, :, i % tr.KG]

    # the hand-made rows (and the padding) have flat z planes
    extra = ((cols[12] == 0) & (cols[13] == 0)).nonzero()[:, 0].tolist()
    assert len(extra) >= 14
    for i in extra:
        assert not bool((by_id(hit, i) & ~by_id(live, i)).any())
    overflow = [i for i in extra if float(cols[0, i]) >= 1e36]
    assert overflow and bool(by_id(hit, overflow[0]).any())
    nan_rows = [i for i in extra if bool(cols[:12, i].isnan().any())]
    assert nan_rows and not any(bool(by_id(hit, i).any()) for i in nan_rows)


def test_cull_rejects_offscreen_and_reject_rows():
    """A triangle far from a warp's rectangle and a back-facing one of
    ordinary size are rejected for that warp."""
    sx = torch.tensor([[10.5], [60.5], [10.5]])
    sy = torch.tensor([[2.5], [2.5], [6.5]])
    ea, eb, ec, bias = _edges(sx.flip(0), sy.flip(0), W, H)
    front = torch.stack(ea + eb + ec + bias).reshape(12, 1)
    ea, eb, ec, bias = _edges(sx, sy, W, H)
    back = torch.stack(ea + eb + ec + bias).reshape(12, 1)
    assert bool((back[9:12] == tr.REJECT).all())
    x0, x1 = torch.tensor([[0.5, 200.5]]), torch.tensor([[31.5, 231.5]])
    y0, y1 = torch.tensor([[0.5, 64.5]]), torch.tensor([[7.5, 71.5]])

    def survives(r):
        ok = torch.ones((1, 2), dtype=torch.bool)
        for e in range(3):
            ok &= tr._edge_may_pass(r[e], r[3 + e], r[6 + e], r[9 + e],
                                    x0, x1, y0, y1)
        return ok[0].tolist()

    assert survives(front) == [True, False]
    assert survives(back) == [False, False]


def test_warp_layout_tiles_the_tile():
    """The warps' pixels partition each tile into 32x8 blocks, PARTS
    parts of WARPS // PARTS warps, in the kernel's order: warp i of part
    q starts at column PART_W q + 32 (i % m), row 8 (i // m), m the
    warps across a part."""
    px, py = tr.warp_pixel_centers(256, 32, (128, 16), "cpu")
    assert px.shape == (4, tr.WARPS, 256)
    flat_x, flat_y = tr._pixel_centers(256, 32, (128, 16), "cpu")
    for t in range(4):
        got = set(zip(px[t].flatten().tolist(), py[t].flatten().tolist()))
        assert got == set(zip(flat_x[t].tolist(), flat_y[t].tolist()))
    tx0, ty0 = float(flat_x[1].min()), float(flat_y[1].min())
    m = tr.PART_W // tr.WARP_W
    for w in range(tr.WARPS):
        part, i = divmod(w, tr.WARPS // tr.PARTS)
        x = px[1, w].reshape(tr.WARP_H, tr.WARP_W)
        y = py[1, w].reshape(tr.WARP_H, tr.WARP_W)
        assert float(x.min()) == tx0 + tr.PART_W * part + 32 * (i % m)
        assert float(y.min()) == ty0 + 8 * (i // m)
        assert float(x.max() - x.min()) == 31 and float(y.max() - y.min()) == 7
        assert (x[:, 1:] - x[:, :-1] == 1).all()
        assert (y[1:] - y[:-1] == 1).all()


def test_roofline_counts_equal_the_twin(monkeypatch):
    """The roofline's surviving counts are the cull twin's entries: over
    a frame's binned inputs and over one rep of the probe's tile."""
    monkeypatch.setattr(raster_roofline, "W", W)
    monkeypatch.setattr(raster_roofline, "H", H)
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    bones = demo.demo_bone_mats(0.3)
    cam = demo.demo_camera(9, W, H)
    vps = []
    for i in range(3):
        cam.yaw = 15.0 + 3.0 * i
        vps.append(np.asarray(cam.view_proj()))
    maxc = td.auto_maxc(batch, vps[0], bones, width=W, height=H)
    scene = td.upload(batch, device="cpu")
    want = []
    for vp in vps:
        cols, bbox = td.setup_packed_cols(scene, td.vertex_stage(
            scene, vp, bones), W, H)
        pre = tr.prebin(cols, bbox, 0, 0, width=W, height=H, maxc=maxc)
        want.append(int(tr.warp_cull_reference(
            cols, *pre[:3], (0, 0), width=W, height=H).sum()))
    assert raster_roofline.surviving_pairs(scene, vps, bones,
                                           maxc) == sorted(want)[1]
    chunk = raster_roofline.covering_chunk("cpu")
    live = tr.warp_cull_reference(
        chunk, torch.zeros((1, 1), dtype=torch.int32),
        torch.full((1, 1), (1 << tr.G) - 1, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32), (0, 0), width=tr.TILE_W,
        height=tr.TILE_H)
    n = raster_roofline.probe_surviving(chunk)
    assert n == int(live.sum()) > 0
    full = raster_roofline.full_cover_chunk("cpu")
    assert raster_roofline.probe_surviving(full) == tr.CT * tr.WARPS
    assert bool((tr.raster_micro_reference(full, 1, 0)[1] >= 0).all())
    hit = pixel_hits(chunk, torch.zeros((1, 1), dtype=torch.int32),
                     torch.full((1, 1), (1 << tr.G) - 1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32), (0, 0),
                     width=tr.TILE_W, height=tr.TILE_H)
    assert not bool((hit & ~live).any())
    r = dict(test_ns=2.0, eval_ns=0.5)
    assert raster_roofline.floor_ms(10, 100, r) == pytest.approx(
        (10 * tr.WARPS * 2.0 + 100 * 0.5) / 1e6)


def test_breakdown_pair_histogram():
    """The roofline's K1 breakdown, per-tile pairs: the popcount of the first
    ``counts`` slots' masks; the share is total x parts over the CTAs
    the card holds."""
    lists = torch.tensor([[0, 1, -1], [2, -1, -1], [-1, -1, -1]],
                         dtype=torch.int32)
    glists = torch.tensor([[0b101, 0xFFF, 0], [0b1, 0, 0], [0, 0, 0]],
                          dtype=torch.int32)
    counts = torch.tensor([2, 1, 0], dtype=torch.int32)
    pairs = raster_roofline.tile_pairs(lists, glists, counts)
    assert pairs.tolist() == [14, 1, 0]
    h = raster_roofline.pair_histogram(pairs, resident=3, parts=2)
    assert (h["pairs"], h["max"], h["live_tiles"]) == (15, 14, 2)
    assert h["share"] == 10.0 and h["heavy_over_share"] == 1.4
    assert h["mean"] == 7.5


def test_breakdown_refuses_without_a_card():
    """K1's breakdown times the card only: without one it raises, alone
    (``--k1``) or inside the roofline."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raster_roofline.main(["world", "--k1"])
    scene = td.upload(demo.build_demo_batch(instances=1, skinned=False),
                      device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raster_roofline.k1_breakdown(scene, [np.eye(4, dtype=np.float32)],
                                     None, 1)


def test_no_winner_keeps_the_work_and_covers_nothing():
    """The breakdown's no-winner inputs: the cull's survivors (so the
    evaluated pairs) are unchanged, no pixel is covered (so K1's
    epilogue gathers nothing), and the outputs are the uncovered
    ones."""
    args, kw = _scene_args("demo")
    cols = args[0]
    nowin = raster_roofline.no_winner(cols)
    assert torch.equal(nowin[:12], cols[:12])
    assert torch.equal(nowin[15:], cols[15:])
    assert torch.equal(tr.warp_cull_reference(nowin, *args[1:], **kw),
                       tr.warp_cull_reference(*args, **kw))
    z, ib, attrs, tapidx = tr.raster_fwd_reference(
        nowin, *args[1:], **kw, w_eps=td.W_EPS)
    assert int((tr.raster_fwd_reference(*args, **kw, w_eps=td.W_EPS)[1]
                >= 0).sum()) > 0
    assert bool((ib == -1).all()) and bool((z == 1.0).all())
    assert not bool(attrs.any()) and not bool(tapidx.any())


def test_layout_matches_the_kernel_header():
    """raster.py's copy of K1's CTA layout is the one csrc/raster_group.cuh
    compiles (the card checks the built library the same way)."""
    src = (Path(tr.__file__).resolve().parent.parent / "csrc"
           / "raster_group.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("PARTS"), const("WARP_W"), const("WARP_H")) == \
        tr.LAYOUT[:3]
    assert tr.PART_W * tr.TILE_H // (tr.WARP_W * tr.WARP_H) * 32 == \
        tr.LAYOUT[3]
