"""Raster roofline on the card: how close K1 runs to its speed of light,
how far its binned work sits above what it has to evaluate, and what
the rest of its time is made of.

    python -m mt_renderer_tpu_torch.tools.raster_roofline [default|dense|world ...] [--k1]
    python -m mt_renderer_tpu_torch.tools.raster_roofline [glass|glass_mip|opaque|opaque_mip ...] --k2 [--layers=4]

The counterpart of ``tools/bench/raster_roofline.py``, for the H100.
K1's group body (``csrc/raster_group.cuh``) first culls each group
against each warp's 32x8 rectangle, then evaluates the survivors, so its
work has two units and two rates:

1. **Rates (SOL).** The probe kernel K3 (``raster.raster_micro``,
   ``csrc/raster_micro.cu``) runs that body on one chunk staged in
   shared memory, with no chunk loads, group gates or binning, in
   ``raster.card_rows`` identical rows that fill every SM at K1's
   occupancy. Per rep and row it does 12 x ``raster.WARPS`` cull tests
   (one per (group, warp)) and evaluates the surviving (triangle, warp)
   pairs, counted by ``raster.warp_cull_reference``. It is timed on two
   chunks: chunk 0 of the preset's first view, which covers nothing of
   the probe's tile (cull tests alone), and ``full_cover_chunk``,
   whose 384 triangles each cover the whole tile, so every (triangle,
   warp) pair survives and every warp is busy: the evaluation at full
   density, the fastest the body can go. (A scene's chunk crowds its
   survivors into a few warps of the tile, and its rate is then the
   latency of those warps, not the body's throughput.) Each time is the
   difference of CUDA-event times at two rep counts over the reps and
   rows that difference added; the two equations give ``test_ns`` per
   (group, warp) and ``eval_ns`` per surviving (triangle, warp),
   card-wide rates like K1's below.
2. **K1's breakdown** (``k1_breakdown``), on each view's prebinned
   inputs, ``raster.raster_fwd`` alone replayed from a CUDA graph (so
   the device's time only: in a loop of calls the wrapper's host time
   hides a launch shorter than it), the median over repeats of the mean
   over the views: ``k1_ms``; ``empty_ms``, every tile's chunk count 0
   (the launch, the epilogue without coefficient gathers, the output
   writes); ``nowin_ms``, every z plane
   set to -1 (``no_winner``: the same chunk loads, cull and evaluation,
   but no pixel is covered, so the epilogue gathers nothing); so
   ``gather_ms`` = k1 - nowin prices the epilogue's coefficient gathers
   and nowin - empty the loop. ``fill_ms`` is one ``zero_`` of K1's
   output bytes (the card's own rate for those writes; K1 never calls
   it). View 0's live (tile, group) pairs per tile give the heaviest
   tile over a CTA's share: each of a tile's ``raster.PARTS`` CTAs
   walks the tile's whole list, so a CTA's share is total pairs x parts
   over the CTAs the card holds at once (SMs x ``raster.blocks_per_sm``).
3. **Utilization.** ``k1_ms`` against its floor at the probe's rates:
   live (group, warp) pairs (binned pairs x WARPS) x ``test_ns`` +
   surviving (triangle, warp) pairs x ``eval_ns``. The gap prices what
   surrounds the loop: chunk loads, the barriers, the epilogue, the tail
   of the grid. K1's ns per binned (group, tile) pair is printed too, the
   unit of the earlier design's speed of light.
4. **Pair slack.** Binned pairs (the popcount of the tiles' group masks)
   over winning pairs (distinct (tile, group) pairs whose group wins at
   least one pixel): how much work perfect binning could skip.

Presets: ``default``, the headline (the skinned demo scene, 1024
instances at subdiv 4, 196,608 triangles, 1920x1080); ``dense``, the
same with the camera position scaled by 0.3 (inside the field); and
``world``, the archive world as the reference builds it (280 buildings,
``building_subdivs=(4, 6, 8, 10, 12)``, the characters' palettes at
scheduler frame 0.5, the world camera), whose K1 runs the mtap
epilogue; eight views each, the yaw stepping 3 degrees. Prints the
card, the rates line and one summary line per preset; with ``--k1``,
only K1's breakdown line per preset (no probe, no cull counts: it runs
on any checkout whose K1 takes ``raster_fwd``'s arguments). Refuses to
run without a CUDA device.

5. **K2's breakdown** (``--k2``, ``k2_breakdown``): the multi-layer
   raster K2 (``raster.raster_fwd_ml``) as the frames call it, at
   1920x1080 over eight views (yaw + 3i degrees): ``glass``, the glass
   scene's translucent set behind K1's opaque z-buffer (``zhi``, no
   opaque cull, tap, quad pool: the split peel); ``glass_mip``, the same
   with the tri pool, mtap + lit; ``opaque``, the headline scene with
   the opaque cull (``full``, tap: the ml peel on an opaque stack);
   ``opaque_mip``, the same, tri pool, mtap + lit. L = 4 (the glass
   preset's peel depth) unless ``--layers=2,4,8`` asks for others.
   Per case and L, replayed from a CUDA graph as K1's: ``k2_ms``;
   ``empty_ms`` with every chunk count 0 (the launch and the L layers'
   writes); ``fill_ms``, a ``zero_`` of the same output bytes; K2's
   CTAs per SM and per tile; view 0's per-tile pair tail against a
   CTA's share and its surviving (triangle, warp) pairs of the cull
   (``raster.warp_cull_reference``). It runs on an older checkout too
   (one CTA a tile, no occupancy query: where
   ``raster.ml_blocks_per_sm`` is missing it prints "n/a").
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..app.camera import Camera
from ..entry import demo_case, world_case
from ..render import device as dv
from ..render import raster as rs
from ..scene.model import DrawBatch
from . import card_line, cuda_times, graph_times, median, require_cuda

W, H = 1920, 1080
VIEWS = 8                  # views per preset
R1, R2 = 32, 160           # the probe's two rep counts
PRESETS = ("default", "dense", "world")
# K2's cases: (scene, split peel's translucent set behind zhi?, mode, lit)
K2_CASES = {"glass": (dict(translucent=True, cam_scale=0.3), True, "tap",
                      False),
            "glass_mip": (dict(translucent=True, cam_scale=0.3,
                               pool_mode="tri"), True, "mtap", True),
            "opaque": (dict(), False, "tap", False),
            "opaque_mip": (dict(pool_mode="tri"), False, "mtap", True)}
WORLD = dict(buildings=280, building_subdivs=(4, 6, 8, 10, 12))


def build(preset: str, device, *, views: int = VIEWS):
    """(DemoCase or WorldCase, view_proj per view, bone palette, K1's
    epilogue mode) of a preset."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}: one of {PRESETS}")
    if preset == "world":
        case = world_case(device, width=W, height=H, pool_mode="quad",
                          **WORLD)
        base_yaw = case.camera.yaw
        yaws = [base_yaw + 3.0 * i for i in range(views)]
        bones, mode = case.bone_mats(0.5), "mtap"
    else:
        case = demo_case(device, instances=1024, subdiv=4, width=W,
                         height=H, cam_scale=0.3 if preset == "dense" else 1.0)
        yaws = [15.0 + 3.0 * i for i in range(views)]
        bones, mode = case.bone_mats(0.3), "tap"
    vps = []
    for yaw in yaws:
        case.camera.yaw = yaw
        vps.append(case.view_proj())
    return case, vps, bones, mode


def _binned(scene, vp, bones, maxc: int):
    """The W x H frame's setup and binning → (cols, (lists, glists,
    counts, n_over), padded width, padded height)."""
    pw, ph = dv._padded(W, H)
    cols, bbox = dv.setup_packed_cols(scene, dv.vertex_stage(scene, vp,
                                                             bones), W, H)
    return cols, rs.prebin(cols, bbox, 0, 0, width=pw, height=ph,
                           maxc=maxc), pw, ph


def pair_counts(scene, vps, bones, maxc: int) -> tuple[int, int]:
    """(median binned pairs, median winning pairs) over the views:
    binned = popcount of the per-tile group masks; winning = distinct
    (tile, group) pairs whose group wins at least one pixel. Counts, not
    times: it runs on any device."""
    binned, winning = [], []
    for vp in vps:
        cols, (lists, glists, counts, _), pw, ph = _binned(scene, vp,
                                                           bones, maxc)
        g = torch.where(lists >= 0, glists, 0)
        binned.append(sum(int(((g >> k) & 1).sum()) for k in range(rs.G)))
        ib = rs.raster_fwd(cols, lists, glists, counts, (0, 0), width=pw,
                           height=ph, w_eps=dv.W_EPS)[1][:, 0, :]
        grp = torch.where(ib >= 0, ib // rs.KG, -1).to(torch.int64)
        keys = grp + (1 << 40) * torch.arange(
            ib.shape[0], device=ib.device)[:, None]
        winning.append(int(torch.unique(keys[grp >= 0]).numel()))
    return median(binned), median(winning)


def surviving_pairs(scene, vps, bones, maxc: int) -> int:
    """Median over the views of K1's surviving (triangle, warp) pairs:
    the entries of ``raster.warp_cull_reference`` on each view's binned
    inputs. A count: it runs on any device."""
    out = []
    for vp in vps:
        cols, (lists, glists, counts, _), pw, ph = _binned(scene, vp,
                                                           bones, maxc)
        out.append(int(rs.warp_cull_reference(
            cols, lists, glists, counts, (0, 0), width=pw,
            height=ph).sum()))
    return median(out)


def probe_surviving(chunk) -> int:
    """Surviving (triangle, warp) pairs of one rep of the probe K3 on
    ``chunk``: its tile at the origin, the chunk once, every group."""
    dev = chunk.device
    one = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    return int(rs.warp_cull_reference(
        chunk[:, :rs.CT].contiguous(), one, one + (1 << rs.G) - 1,
        torch.ones(1, dtype=torch.int32, device=dev), (0, 0),
        width=rs.TILE_W, height=rs.TILE_H).sum())


def chunk0(scene, vp, bones, width: int, height: int):
    """The first chunk's columns of a view's setup at width x height."""
    cols, _ = dv.setup_packed_cols(scene, dv.vertex_stage(scene, vp, bones),
                                   width, height)
    return cols[:, :rs.CT].contiguous()


def covering_chunk(device):
    """Chunk 0 of the 4-instance demo scene at 128x16, which covers part
    of the probe's tile (39 surviving (triangle, warp) pairs a rep)."""
    small = demo_case(device, instances=4, subdiv=1, width=rs.TILE_W,
                      height=rs.TILE_H)
    return chunk0(small.scene, small.view_proj(), small.bone_mats(0.3),
                  rs.TILE_W, rs.TILE_H)


def full_cover_chunk(device, seed: int = 0):
    """One chunk of 384 front-facing triangles, each far larger than the
    probe's 128x16 view, at seeded depths between 2.2 and 4 units from
    the camera, set up by the port's own upload, vertex and setup
    stages: every pixel of the tile lies inside every triangle, so all
    384 x WARPS (triangle, warp) pairs survive the cull."""
    rng = np.random.default_rng(seed)
    t = rs.CT
    pos = np.tile(np.float32([[-50.0, -50.0, 0.0], [50.0, -50.0, 0.0],
                              [0.0, 50.0, 0.0]]), (t, 1))
    pos[:, 2] = np.repeat(rng.uniform(-1.0, 0.8, t), 3)
    n = 3 * t
    batch = DrawBatch(
        positions=pos, uvs=np.zeros((n, 2), np.float32),
        joints=np.zeros((n, 4), np.int32),
        weights=np.zeros((n, 4), np.float32),
        tris=np.arange(n, dtype=np.int32).reshape(t, 3),
        tri_texture=np.zeros(t, np.int32), tri_parts=np.zeros(t, np.int32),
        tri_debug_id=np.zeros(t, np.int32),
        textures=[np.full((8, 8, 4), 255, np.uint8)])
    cam = Camera(position=[0.0, 0.0, 3.0])
    cam.aspect = rs.TILE_W / rs.TILE_H
    scene = dv.upload(batch, device=device)
    return chunk0(scene, np.asarray(cam.view_proj()), None, rs.TILE_W,
                  rs.TILE_H)


def probe_ns_per_rep(chunk, *, repeats: int = 5) -> float:
    """Card-wide ns per (rep, row) of K3 on ``chunk``: the median over
    ``repeats`` of its time at R2 reps less its time at R1, over (R2 -
    R1) x rows."""
    dev = require_cuda(chunk.device)
    rows = rs.card_rows(dev)
    ests = []
    for _ in range(repeats):
        t1, t2 = (cuda_times(lambda _i, r=r: rs.raster_micro(
            chunk, r, rs.N_COEF, rows), dev, 1)[0] for r in (R1, R2))
        ests.append((t2 - t1) * 1e6 / ((R2 - R1) * rows))
    return median(ests)


def rates(scene, vp, bones, *, repeats: int = 5) -> dict:
    """K1's two rates from the probe (see the module docstring): chunk 0
    of the view at W x H (cull tests alone, where it covers nothing of
    the probe's tile) and the covering chunk → test_ns per (group,
    warp), eval_ns per surviving (triangle, warp), the counts and
    times they come from."""
    dev = require_cuda(scene.device)
    tests = rs.G * rs.WARPS
    chunks = (chunk0(scene, vp, bones, W, H), full_cover_chunk(dev))
    (s_a, s_b) = (probe_surviving(c) for c in chunks)
    t_a, t_b = (probe_ns_per_rep(c, repeats=repeats) for c in chunks)
    if s_b <= s_a:
        raise RuntimeError(f"the covering chunk leaves {s_b} survivors, "
                           f"the empty one {s_a}: no rate to solve for")
    eval_ns = (t_b - t_a) / (s_b - s_a)
    return dict(test_ns=(t_a - s_a * eval_ns) / tests, eval_ns=eval_ns,
                surviving_empty=s_a, surviving_cover=s_b,
                ns_rep_empty=t_a, ns_rep_cover=t_b, rows=rs.card_rows(dev))


def tile_pairs(lists, glists, counts):
    """Live (tile, group) pairs per tile, (n_tiles,) i64: the popcount
    of the group masks of the first ``counts`` list slots."""
    slot = torch.arange(lists.shape[1], device=lists.device)
    g = torch.where((slot[None, :] < counts[:, None]) & (lists >= 0),
                    glists, 0)
    return sum(((g >> k) & 1).sum(1, dtype=torch.int64)
               for k in range(rs.G))


def pair_histogram(pairs, resident: int, parts: int) -> dict:
    """The per-tile pair counts' total, maximum, 90th percentile and
    mean over tiles with work, and the heaviest tile over a CTA's share
    (total x parts / resident CTAs)."""
    live = pairs[pairs > 0].double()
    total = int(pairs.sum())
    share = total * parts / resident
    top = int(pairs.max()) if pairs.numel() else 0
    return dict(live_tiles=int(live.numel()), pairs=total, max=top,
                p90=float(torch.quantile(live, 0.9)) if live.numel() else 0.0,
                mean=float(live.mean()) if live.numel() else 0.0,
                share=share, heavy_over_share=top / share if share else 0.0)


def no_winner(cols):
    """A copy of ``cols`` whose z planes are -1 at every pixel: the edges
    (so the cull and the evaluated pairs) are unchanged, but the z >= 0
    test fails everywhere, so no pixel is covered and K1's epilogue
    gathers no coefficients."""
    out = cols.clone()
    out[12:14] = 0.0
    out[14] = -1.0
    return out


def k1_breakdown(scene, vps, bones, maxc: int, *, mode: str = "tap",
                 repeats: int = 5) -> dict:
    """K1's time with the ``mode`` epilogue on the views' prebinned
    inputs, beside the same launches with the chunk counts zeroed and
    with no winner, a fill of its output bytes, its CTAs per SM and view
    0's per-tile pair histogram (see the module docstring)."""
    dev = require_cuda(scene.device)
    runs = []
    for vp in vps:
        cols, (lists, glists, counts, _), pw, ph = _binned(scene, vp, bones,
                                                           maxc)
        runs.append(dict(
            k1=(cols, lists, glists, counts),
            empty=(cols, lists, glists, torch.zeros_like(counts)),
            nowin=(no_winner(cols), lists, glists, counts)))
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode=mode)

    def ms(what):
        return median(graph_times(
            lambda i: rs.raster_fwd(*runs[i][what], (0, 0), **kw), dev,
            repeats, calls=len(runs)))

    out = {f"{what}_ms": ms(what) for what in ("k1", "empty", "nowin")}
    out_bytes = sum(o.numel() * o.element_size()
                    for o in rs.raster_fwd(*runs[0]["empty"], (0, 0), **kw))
    buf = torch.empty(out_bytes // 4, dtype=torch.float32, device=dev)
    out["fill_ms"] = median(graph_times(lambda _i: buf.zero_(), dev, repeats,
                                        calls=len(runs)))
    bps = rs.blocks_per_sm(dev)
    resident = torch.cuda.get_device_properties(dev).multi_processor_count \
        * bps
    parts = getattr(rs, "PARTS", 1)     # 1: a K1 of one CTA per tile
    return dict(out, mode=mode, gather_ms=out["k1_ms"] - out["nowin_ms"],
                out_mb=out_bytes / 1e6, blocks_per_sm=bps,
                resident_ctas=resident, parts=parts,
                **pair_histogram(tile_pairs(*runs[0]["k1"][1:]), resident,
                                 parts))


def k2_inputs(case: str, device, *, views: int = VIEWS,
              instances: int = 1024, subdiv: int = 4) -> tuple:
    """K2's launches of one case (``K2_CASES``) over the views, as the
    frames make them, on the demo scene of ``instances`` at ``subdiv``
    (the headline's by default) → ([(positional args, keywords) per
    view], the case's mode)."""
    if case not in K2_CASES:
        raise ValueError(f"unknown K2 case {case!r}: one of "
                         f"{tuple(K2_CASES)}")
    scene_kw, split, mode, lit = K2_CASES[case]
    demo = demo_case(device, instances=instances, subdiv=subdiv, width=W,
                     height=H, **scene_kw)
    bones = demo.bone_mats(0.3)
    light = dv._light_unit() if lit else None
    pw, ph = dv._padded(W, H)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode=mode, light=light)
    out, maxc = [], None
    for i in range(views):
        demo.camera.yaw = 15.0 + 3.0 * i
        vp = demo.view_proj()
        if maxc is None:
            maxc = dv.auto_maxc(demo.batch, vp, bones, width=W, height=H)
        clip = dv.vertex_stage(demo.scene, vp, bones)
        setup = dv.setup_packed_cols(demo.scene, clip, W, H,
                                     opacity_split=split, bone_mats=bones,
                                     lighting=lit)
        zhi = None
        if split:
            (cols_op, bbox_op), (cols, bbox) = setup
            pre = rs.prebin(cols_op, bbox_op, 0, 0, width=pw, height=ph,
                            maxc=maxc)
            zo, io = rs.raster_fwd(cols_op, *pre[:3], (0, 0), **kw)[:2]
            zhi = torch.where(io >= 0, zo, float("inf"))
        else:
            cols, bbox = setup
        lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                             height=ph, maxc=maxc)
        out.append(((cols, lists, glists, counts, (0, 0)),
                    dict(kw, opaque_cull=not split, zhi=zhi)))
    rs.flush_overflow_checks()
    return out, mode


def k2_breakdown(runs, layers: int, *, repeats: int = 5) -> dict:
    """K2 at L = ``layers`` on ``k2_inputs``' launches beside the same
    launches with every chunk count 0, a fill of its output bytes, its
    CTAs per SM and view 0's pair tail and surviving (triangle, warp)
    pairs (see the module docstring)."""
    args0, kw0 = runs[0]
    dev = require_cuda(args0[0].device)
    kws = [dict(kw, layers=layers) for _, kw in runs]
    empty = [(*a[:3], torch.zeros_like(a[3]), a[4]) for a, _ in runs]

    def ms(argv):
        return median(graph_times(lambda i: rs.raster_fwd_ml(*argv[i],
                                                             **kws[i]),
                                  dev, repeats, calls=len(runs)))

    out = dict(k2_ms=ms([a for a, _ in runs]), empty_ms=ms(empty))
    out_bytes = sum(o.numel() * o.element_size()
                    for o in rs.raster_fwd_ml(*empty[0], **kws[0]))
    buf = torch.empty(out_bytes // 4, dtype=torch.float32, device=dev)
    out["fill_ms"] = median(graph_times(lambda _i: buf.zero_(), dev, repeats,
                                        calls=len(runs)))
    del buf
    occupancy = getattr(rs, "ml_blocks_per_sm", None)
    parts = rs.PARTS if occupancy else 1    # 1: a K2 of one CTA per tile
    bps = occupancy(dev, layers, kw0["opaque_cull"],
                    kw0["zhi"] is not None) if occupancy else None
    resident = (torch.cuda.get_device_properties(dev).multi_processor_count
                * (bps or 1))
    cols, lists, glists, counts, origin = args0
    live = rs.warp_cull_reference(cols, lists, glists, counts, origin,
                                  width=kw0["width"], height=kw0["height"])
    return dict(out, layers=layers, out_mb=out_bytes / 1e6,
                blocks_per_sm=bps, parts=parts, surviving=int(live.sum()),
                **pair_histogram(tile_pairs(lists, glists, counts), resident,
                                 parts))


def k2_line(case: str, r: dict) -> str:
    bps = "n/a" if r["blocks_per_sm"] is None else r["blocks_per_sm"]
    return (f"K2 {case} L={r['layers']}: k2={r['k2_ms']!r}ms "
            f"empty(counts=0)={r['empty_ms']!r}ms "
            f"fill({r['out_mb']!r}MB)={r['fill_ms']!r}ms; {bps} CTAs per "
            f"SM, {r['parts']} per tile; view 0: pairs={r['pairs']} "
            f"surviving={r['surviving']} live_tiles={r['live_tiles']} "
            f"max={r['max']} p90={r['p90']!r} mean={r['mean']!r} "
            f"share={r['share']!r} heavy/share={r['heavy_over_share']!r}")


def floor_ms(pairs: int, surviving: int, r: dict) -> float:
    """K1's floor at the probe's rates: live (group, warp) pairs x
    test_ns + surviving (triangle, warp) pairs x eval_ns."""
    return (pairs * rs.WARPS * r["test_ns"] + surviving * r["eval_ns"]) / 1e6


def roofline(preset: str, device, *, views: int = VIEWS, repeats: int = 5,
             sol: dict | None = None) -> dict:
    """One preset's readings on the card: triangles, maxc, K1's breakdown
    (its ms as ``raster_ms``), binned, winning and surviving pairs,
    slack, K1 ns per binned pair, the rates (``sol``: measured on this
    preset's first view unless given), the floor and the utilization."""
    dev = require_cuda(device)
    case, vps, bones, mode = build(preset, dev, views=views)
    maxc = dv.auto_maxc(case.batch, vps[0], bones, width=W, height=H)
    if sol is None:
        sol = rates(case.scene, vps[0], bones, repeats=repeats)
    binned, winning = pair_counts(case.scene, vps, bones, maxc)
    surviving = surviving_pairs(case.scene, vps, bones, maxc)
    k1 = k1_breakdown(case.scene, vps, bones, maxc, mode=mode,
                      repeats=repeats)
    ms = k1["k1_ms"]
    rs.flush_overflow_checks()
    floor = floor_ms(binned, surviving, sol)
    return dict(k1, preset=preset, tris=len(case.batch.tris),
                maxc=maxc, raster_ms=ms, pairs=binned, winning=winning,
                slack=binned / max(winning, 1), surviving=surviving,
                survive_share=surviving / max(binned * rs.WARPS * rs.KG, 1),
                ns_pair=ms * 1e6 / binned, sol=sol, floor_ms=floor,
                util=floor / ms)


def rates_line(r: dict) -> str:
    return (f"rates (K1's group body on a resident chunk, no loads or "
            f"gates, {r['rows']} rows of {rs.PARTS} CTAs): "
            f"test_ns={r['test_ns']!r} per (group, warp), "
            f"eval_ns={r['eval_ns']!r} per surviving (triangle, warp); "
            f"ns/rep/row {r['ns_rep_empty']!r} with "
            f"{r['surviving_empty']} survivors, {r['ns_rep_cover']!r} with "
            f"{r['surviving_cover']}")


def k1_line(r: dict) -> str:
    return (f"K1 {r['mode']}: k1={r['k1_ms']!r}ms "
            f"empty(counts=0)={r['empty_ms']!r}ms "
            f"nowin(z<0)={r['nowin_ms']!r}ms gather={r['gather_ms']!r}ms "
            f"({r['gather_ms'] / r['k1_ms'] * 100!r}%) "
            f"fill({r['out_mb']!r}MB)={r['fill_ms']!r}ms; "
            f"{r['blocks_per_sm']} CTAs per SM, {r['parts']} per tile, "
            f"{r['resident_ctas']} resident; view 0: pairs={r['pairs']} "
            f"live_tiles={r['live_tiles']} max={r['max']} p90={r['p90']!r} "
            f"mean={r['mean']!r} share={r['share']!r} "
            f"heavy/share={r['heavy_over_share']!r}")


def summary_line(r: dict) -> str:
    return (f"{r['preset']:8s} tris={r['tris']} maxc={r['maxc']} "
            f"raster={r['raster_ms']!r}ms pairs={r['pairs']} "
            f"winning={r['winning']} slack={r['slack']!r}x "
            f"surviving={r['surviving']} "
            f"({r['survive_share'] * 100!r}% of binned (triangle, warp)) "
            f"ns/pair={r['ns_pair']!r} floor={r['floor_ms']!r}ms "
            f"util={r['util'] * 100!r}%; " + k1_line(r))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    names = [a for a in args if not a.startswith("-")]
    dev = require_cuda()
    print(f"card: {torch.cuda.get_device_name(dev)}; {card_line()}",
          flush=True)
    if "--k2" in args:
        layers = [4]
        for a in args:
            if a.startswith("--layers="):
                layers = [int(x) for x in a.split("=", 1)[1].split(",")]
        for case in names or list(K2_CASES):
            runs, _ = k2_inputs(case, dev)
            for n in layers:
                print(k2_line(case, k2_breakdown(runs, n)), flush=True)
            del runs
        return 0
    presets = names or list(PRESETS)
    sol = None
    for preset in presets:
        if "--k1" in args:
            case, vps, bones, mode = build(preset, dev)
            maxc = dv.auto_maxc(case.batch, vps[0], bones, width=W,
                                height=H)
            r = k1_breakdown(case.scene, vps, bones, maxc, mode=mode)
            print(f"{preset:8s} tris={len(case.batch.tris)} maxc={maxc} "
                  + k1_line(r), flush=True)
            continue
        r = roofline(preset, dev, sol=sol)
        if sol is None:
            sol = r["sol"]
            print(rates_line(sol), flush=True)
        print(summary_line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
