"""Raster roofline on the card: how close K1 runs to its speed of light,
and how far its binned work sits above the visible surface.

    python -m mt_renderer_tpu_torch.tools.raster_roofline [default|dense ...]

The counterpart of ``tools/bench/raster_roofline.py``, for the H100:

1. **Speed of light (SOL).** The probe kernel K3 (``raster.raster_micro``,
   ``csrc/raster_micro.cu``) runs K1's group body (``csrc/
   raster_group.cuh``, the very code K1 runs) on one chunk staged in
   shared memory, with no chunk loads, group gates or binning, in enough
   identical CTAs to fill every SM at K1's occupancy. SOL ns/pair is the
   difference of its CUDA-event times at two rep counts over the
   (group, tile) pairs the difference added: (r2 - r1) x 12 x ctas. It is
   a card-wide rate, like K1's below.
2. **Utilization.** K1's time (CUDA events around ``raster.raster_fwd``
   alone, on prebinned inputs, the median over repeats of the mean over
   the views) over its binned pairs is its ns/pair; SOL over that is its
   utilization. The gap prices what surrounds the math: chunk loads,
   the gates, the chunk loop, the epilogue, the tail of the grid.
3. **Pair slack.** Binned pairs (the popcount of the tiles' group masks,
   K1's unit of work) over winning pairs (distinct (tile, group) pairs
   whose group wins at least one pixel): how much work perfect binning
   could skip.

Presets: ``default``, the headline (the skinned demo scene, 1024
instances at subdiv 4, 196,608 triangles, 1920x1080); ``dense``, the
same with the camera position scaled by 0.3 (inside the field); and
``world``, the archive world as the reference builds it (280 buildings,
``building_subdivs=(4, 6, 8, 10, 12)``, the characters' palettes at
scheduler frame 0.5, the world camera), whose K1 runs the mtap
epilogue; eight views each, the yaw stepping 3 degrees. Prints the
card, the SOL line and one summary line per preset. Refuses to run
without a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from ..entry import demo_case, world_case
from ..render import device as dv
from ..render import raster as rs
from . import card_line, cuda_times, median, require_cuda

W, H = 1920, 1080
VIEWS = 8                  # views per preset
R1, R2 = 32, 160           # the probe's two rep counts
PRESETS = ("default", "dense", "world")
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


def raster_ms(scene, vps, bones, maxc: int, *, repeats: int = 5,
              mode: str = "tap") -> float:
    """K1's time in ms per frame with the ``mode`` epilogue: CUDA events
    around ``raster_fwd`` alone on each view's prebinned inputs, the
    median over ``repeats`` of the mean over the views."""
    dev = require_cuda(scene.device)
    runs = [_binned(scene, vp, bones, maxc) for vp in vps]

    def call(i):
        cols, pre, pw, ph = runs[i]
        rs.raster_fwd(cols, *pre[:3], (0, 0), width=pw, height=ph,
                      w_eps=dv.W_EPS, mode=mode)

    return median(cuda_times(call, dev, repeats, calls=len(runs)))


def sol_ns_per_pair(scene, vp, bones, *,
                    repeats: int = 5) -> tuple[float, int]:
    """(SOL ns per (group, tile) pair, CTAs) of K1's group body on chunk
    0 of the view's setup: the median over ``repeats`` of the probe's
    time at R2 reps less its time at R1, over (R2 - R1) x 12 x ctas."""
    dev = require_cuda(scene.device)
    cols, _ = dv.setup_packed_cols(scene, dv.vertex_stage(scene, vp, bones),
                                   W, H)
    chunk = cols[:, :rs.CT].contiguous()
    ctas = (torch.cuda.get_device_properties(dev).multi_processor_count
            * rs.blocks_per_sm(dev))
    ests = []
    for _ in range(repeats):
        t1, t2 = (cuda_times(lambda _i, r=r: rs.raster_micro(
            chunk, r, rs.N_COEF, ctas), dev, 1)[0] for r in (R1, R2))
        ests.append((t2 - t1) * 1e6 / ((R2 - R1) * rs.G * ctas))
    return median(ests), ctas


def roofline(preset: str, device, *, views: int = VIEWS, repeats: int = 5,
             sol: float | None = None) -> dict:
    """One preset's readings on the card: triangles, maxc, K1 ms, binned
    and winning pairs, slack, K1 ns/pair, SOL (measured on this preset's
    first view unless given), utilization and the time floors at SOL."""
    dev = require_cuda(device)
    case, vps, bones, mode = build(preset, dev, views=views)
    maxc = dv.auto_maxc(case.batch, vps[0], bones, width=W, height=H)
    ctas = None
    if sol is None:
        sol, ctas = sol_ns_per_pair(case.scene, vps[0], bones,
                                    repeats=repeats)
    binned, winning = pair_counts(case.scene, vps, bones, maxc)
    ms = raster_ms(case.scene, vps, bones, maxc, repeats=repeats, mode=mode)
    rs.flush_overflow_checks()
    ns_pair = ms * 1e6 / binned
    return dict(preset=preset, tris=len(case.batch.tris), maxc=maxc,
                raster_ms=ms, pairs=binned, winning=winning,
                slack=binned / max(winning, 1), ns_pair=ns_pair, sol=sol,
                ctas=ctas, util=sol / ns_pair,
                floor_ms=binned * sol / 1e6,
                floor_winning_ms=winning * sol / 1e6)


def summary_line(r: dict) -> str:
    return (f"{r['preset']:8s} tris={r['tris']} maxc={r['maxc']} "
            f"raster={r['raster_ms']!r}ms pairs={r['pairs']} "
            f"winning={r['winning']} slack={r['slack']!r}x "
            f"ns/pair={r['ns_pair']!r} util={r['util'] * 100!r}% "
            f"floor@SOL={r['floor_ms']!r}ms "
            f"floor@SOL,winning={r['floor_winning_ms']!r}ms")


def main(argv=None) -> int:
    presets = [a for a in (sys.argv[1:] if argv is None else argv)
               if not a.startswith("-")] or list(PRESETS)
    dev = require_cuda()
    print(f"card: {torch.cuda.get_device_name(dev)}; {card_line()}",
          flush=True)
    sol = None
    for preset in presets:
        r = roofline(preset, dev, sol=sol)
        if sol is None:
            sol = r["sol"]
            print(f"SOL (K1's group body on a resident chunk, no loads or "
                  f"gates, {r['ctas']} CTAs): {sol!r} ns/pair", flush=True)
        print(summary_line(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
