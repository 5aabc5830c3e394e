"""Where a frame's time goes: host cap guard, device path, stages, kernels.

    python -m mt_renderer_tpu_torch.frame_profile            # headline, GPU
    python -m mt_renderer_tpu_torch.frame_profile --mipmap --lighting
    python -m mt_renderer_tpu_torch.frame_profile --translucent --peel 4
    python -m mt_renderer_tpu_torch.frame_profile --translucent --peel 4 \\
        --mipmap --lighting
    python -m mt_renderer_tpu_torch.frame_profile --world --mipmap
    python -m mt_renderer_tpu_torch.frame_profile --device cpu \\
        --instances 4 --subdiv 1 --width 256 --height 128     # rehearsal

At the headline workload (the skinned demo scene, 1024 instances at
subdiv 4, 1920x1080) it prints, one reading per line, for the packed
single-layer frame or, with ``--peel L``, the packed split-peel frame
(``render_frame_peeled(peel_mode="split")``, caps measured by
``measure_live_tap_tiles``). ``--translucent`` renders the glass scene:
every 4th instance translucent, the camera position scaled by 0.3.
``--mipmap`` renders the trilinear frame from the tri pool (the pool
``bench.py`` takes for it), ``--lighting`` the lit frame (both: the
reference bench's ``pallas+mip+light`` row; with ``--peel`` its
``peel4+mip+light`` row). ``--world`` renders the archive world instead
(``--buildings`` buildings of subdivisions (4, 6, 8, 10, 12), the bench's
``pallas world`` row with ``--mipmap``), its palette computed on the
device by ``bone_mats_device``.

* the host predictors ``FrameEngine`` runs before each frame
  (``predict_bin_counts`` + ``auto_tap_tiles``), and ``auto_maxc`` and
  ``skin_positions`` they are built on, in ms over ``--views`` views;
* the frame with the caps fixed (no host guard): view and bones sent
  from the host each frame, then already on the device;
* each stage of the frame timed alone (for the split peel: the opacity
  split setup, binning and K1 over the opaque set, binning and K2 over
  the translucent set, the opaque tap shade and blend, the translucent
  composite, the pack);
* the frame's binning (chunks per tile, live (tile, group) pairs), per
  set for the split peel;
* from ``torch.profiler`` over ``--prof-frames`` device-resident frames:
  device busy time per frame (the union of the kernel and copy
  intervals), the device's idle share against the unprofiled frame, and
  the largest kernels.

Device times use CUDA events on a CUDA device and the host clock on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .entry import demo_case, world_case
from .render import cpu_reference as cr
from .render import device as dv
from .render import raster as rs


def _timed(fn, dev: torch.device, reps: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _device_busy(prof, frames: int) -> tuple[float, float, list]:
    """(busy ms per frame: the union of device-event intervals, span ms
    per frame from the first device event's start to the last one's end,
    the five largest kernels as (name, ms per frame))."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return float("nan"), float("nan"), []
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    per_name: dict[str, float] = {}
    for e in evs:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    return (busy / 1e3 / frames, span / 1e3 / frames,
            [(name[:80], us / 1e3 / frames) for name, us in top])


def _single_stages(scene, clip, w, h, maxc, taps, *, bones=None,
                   mipmap=False, lighting=False):
    """The single-layer frame's stages after the vertex stage, each a
    thunk, and its binning {"": (counts, glists)}."""
    pw, ph = dv._padded(w, h)
    clear = (255,) * 4

    def setup():
        return dv.setup_packed_cols(scene, clip, w, h, bone_mats=bones,
                                    lighting=lighting)

    cols, bbox = setup()
    lists, glists, counts, _ = rs.prebin(cols, bbox, 0, 0, width=pw,
                                         height=ph, maxc=maxc)
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS,
              mode="mtap" if mipmap else "tap",
              light=dv._light_unit() if lighting else None)
    out = rs.raster_fwd(cols, lists, glists, counts, (0, 0), **kw)
    k1 = f"raster_fwd (K1), {kw['mode']}{'+lit' if lighting else ''}"
    stages = {}
    if lighting:
        stages["world_normals"] = lambda: dv.world_normals(scene, bones)
    stages.update({
        f"setup_packed_cols{', lit' if lighting else ''}": setup,
        "prebin": lambda: rs.prebin(cols, bbox, 0, 0, width=pw, height=ph,
                                    maxc=maxc),
        k1: lambda: rs.raster_fwd(cols, lists, glists, counts, (0, 0),
                                  **kw)})
    if mipmap:
        _, ib, mattrs = out
        src, cov, _ = dv.shade_mip_tap_flat_channels(scene, mattrs, ib,
                                                     tap_tiles=taps)
        stages.update({
            f"shade_mip_tap_flat_channels (cap {taps} rows)":
                lambda: dv.shade_mip_tap_flat_channels(
                    scene, mattrs, ib, tap_tiles=taps),
            "shade_mip_tap_flat_channels, dense":
                lambda: dv.shade_mip_tap_flat_channels(scene, mattrs, ib),
            "blend+pack+unflatten+crop": lambda: rs.unflatten_tiles(
                dv._blend_pack_u32(src, cov, clear), ph, pw)[:h, :w]
            .contiguous()})
    else:
        _, ib, tattrs, tapidx = out
        colort, _, _ = dv.shade_finish_tap_flat(scene, tattrs, tapidx, ib,
                                                clear, tap_tiles=taps)
        stages.update({
            "shade_finish_tap_flat": lambda: dv.shade_finish_tap_flat(
                scene, tattrs, tapidx, ib, clear, tap_tiles=taps),
            "shade_finish_tap_flat, dense": lambda: dv.shade_finish_tap_flat(
                scene, tattrs, tapidx, ib, clear, tap_tiles=None),
            "unflatten+crop": lambda: rs.unflatten_tiles(
                colort, ph, pw)[:h, :w].contiguous()})
    return stages, {"": (counts, glists)}


def _peel_stages(scene, clip, w, h, maxc, taps, layers, *, bones=None,
                 mipmap=False, lighting=False):
    """The split-peel frame's stages after the vertex stage, each a
    thunk, and the binning of its two sets."""
    pw, ph = dv._padded(w, h)
    mode = "mtap" if mipmap else "tap"
    kw = dict(width=pw, height=ph, w_eps=dv.W_EPS, mode=mode,
              light=dv._light_unit() if lighting else None)
    lit = dict(bone_mats=bones, lighting=lighting)
    clear = (255,) * 4
    (cols_op, bbox_op), (cols_tr, bbox_tr) = dv.setup_packed_cols(
        scene, clip, w, h, opacity_split=True, **lit)
    pre_op = rs.prebin(cols_op, bbox_op, 0, 0, width=pw, height=ph,
                       maxc=maxc)
    pre_tr = rs.prebin(cols_tr, bbox_tr, 0, 0, width=pw, height=ph,
                       maxc=maxc)
    opaque = rs.raster_fwd(cols_op, *pre_op[:3], (0, 0), **kw)
    zo, io = opaque[:2]
    zhi = torch.where(io >= 0, zo, float("inf"))
    ml = dict(kw, layers=layers, opaque_cull=False, zhi=zhi)
    translucent = rs.raster_fwd_ml(cols_tr, *pre_tr[:3], (0, 0), **ml)
    zt, it = translucent[:2]
    cov_tr = (it >= 0) & ((zt < zhi) | ((zt == zhi) & (it > io)))

    def shade_opaque():
        if mipmap:
            src, cov, _ = dv.shade_mip_tap_flat_channels(
                scene, opaque[2], io, tap_tiles=taps[0])
        else:
            src, cov, _ = dv.shade_tap_flat_channels(
                scene, opaque[2], opaque[3], io, tap_tiles=taps[0])
        return dv._blend_channels(src, cov, clear)

    dst0 = shade_opaque()

    def composite():
        if mipmap:
            return dv.composite_peeled_mip_flat(
                scene, translucent[2], it, layers, clear, tap_tiles=taps[1],
                covered=cov_tr, dst0=dst0)
        return dv.composite_peeled_tap_flat(
            scene, translucent[2], translucent[3], it, layers, clear,
            tap_tiles=taps[1], covered=cov_tr, dst0=dst0)

    dst, _ = composite()
    k = ("" if mode == "tap" and not lighting
         else f", {mode}{'+lit' if lighting else ''}")
    return {
        f"setup_packed_cols, opacity split{', lit' if lighting else ''}":
            lambda: dv.setup_packed_cols(scene, clip, w, h,
                                         opacity_split=True, **lit),
        "prebin, opaque set": lambda: rs.prebin(
            cols_op, bbox_op, 0, 0, width=pw, height=ph, maxc=maxc),
        f"raster_fwd (K1){k}, opaque set": lambda: rs.raster_fwd(
            cols_op, *pre_op[:3], (0, 0), **kw),
        "prebin, translucent set": lambda: rs.prebin(
            cols_tr, bbox_tr, 0, 0, width=pw, height=ph, maxc=maxc),
        f"raster_fwd_ml (K2){k}, translucent set": lambda: rs.raster_fwd_ml(
            cols_tr, *pre_tr[:3], (0, 0), **ml),
        f"opaque {'trilinear' if mipmap else 'tap'} shade + blend":
            shade_opaque,
        f"composite_peeled_{mode}_flat": composite,
        "pack+unflatten+crop": lambda: rs.unflatten_tiles(
            dv.pack_u32_channels(dst), ph, pw)[:h, :w].contiguous(),
    }, {", opaque set": (pre_op[2], pre_op[1]),
        ", translucent set": (pre_tr[2], pre_tr[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--instances", type=int, default=1024)
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--prof-frames", type=int, default=5)
    ap.add_argument("--translucent", action="store_true",
                    help="the glass scene and camera")
    ap.add_argument("--peel", type=int, default=0,
                    help="layers of the split-peel frame; 0 = single layer")
    ap.add_argument("--mipmap", action="store_true",
                    help="the trilinear frame, from the tri pool")
    ap.add_argument("--lighting", action="store_true",
                    help="the lit frame")
    ap.add_argument("--world", action="store_true",
                    help="the archive world instead of the demo scene")
    ap.add_argument("--buildings", type=int, default=280,
                    help="the world's buildings")
    args = ap.parse_args(argv)
    if args.world and (args.translucent or args.peel):
        ap.error("--world profiles the single-layer frame")
    dev = torch.device(args.device)
    w, h = args.width, args.height
    pool = "tri" if args.mipmap else "quad"

    if args.world:
        case = world_case(dev, buildings=args.buildings, width=w, height=h,
                          building_subdivs=(4, 6, 8, 10, 12), pool_mode=pool)
    else:
        case = demo_case(dev, instances=args.instances, subdiv=args.subdiv,
                         width=w, height=h, translucent=args.translucent,
                         cam_scale=0.3 if args.translucent else 1.0,
                         pool_mode=pool)
    batch, scene, cam = case.batch, case.scene, case.camera
    vp, bones = case.view_proj(), case.bone_mats(0.0)
    maxc = dv.auto_maxc(batch, vp, bones, width=w, height=h)
    if args.peel:
        taps = dv.measure_live_tap_tiles(scene, vp, bones, width=w,
                                         height=h, layers=args.peel,
                                         maxc=maxc, lighting=args.lighting,
                                         mode="split")
    else:
        taps = dv.auto_tap_tiles(batch, vp, bones, width=w, height=h)
    print(f"scene: {'world, ' if args.world else ''}{len(batch.tris)} tris, "
          f"{w}x{h}, translucent="
          f"{args.translucent}, peel={args.peel}, mipmap={args.mipmap}, "
          f"lighting={args.lighting}, pool {scene.pool_mode}, maxc={maxc}, "
          f"tap_tiles={taps}, device {dev}")

    # host predictors at views that vary as the smoke's main path does
    host = {k: [] for k in ("predict_bin_counts", "auto_tap_tiles",
                            "auto_maxc", "skin_positions")}
    base_yaw = cam.yaw
    for t in range(args.views):
        cam.yaw = base_yaw + 8.0 * np.sin(0.25 * t)
        v, b = case.view_proj(), case.bone_mats(0.3 * t)
        kw = dict(width=w, height=h)
        host["predict_bin_counts"].append(_host_ms(
            lambda: dv.predict_bin_counts(batch, v, b, **kw)))
        host["auto_tap_tiles"].append(_host_ms(
            lambda: dv.auto_tap_tiles(batch, v, b, **kw)))
        host["auto_maxc"].append(_host_ms(
            lambda: dv.auto_maxc(batch, v, b, **kw)))
        host["skin_positions"].append(_host_ms(
            lambda: cr.skin_positions(batch, b)))
    cam.yaw = base_yaw
    for k, ms in host.items():
        print(f"host {k} ms: {json.dumps(ms)}")
    guard = [a + b for a, b in zip(host["predict_bin_counts"],
                                   host["auto_tap_tiles"])]
    print(f"host guard per frame (predict_bin_counts + auto_tap_tiles) "
          f"ms: {json.dumps(guard)}")

    def frame(v, b):
        if args.peel:
            return dv.render_frame_peeled(
                scene, v, b, width=w, height=h, layers=args.peel,
                maxc=maxc, peel_mode="split", packed=True, tap_tiles=taps,
                mipmap=args.mipmap, lighting=args.lighting)
        return dv.render_frame(scene, v, b, width=w, height=h, maxc=maxc,
                               tap_tiles=taps, packed=True,
                               mipmap=args.mipmap, lighting=args.lighting)

    vp_d = dv._f32(vp, dev)
    bones_d = (case.bone_mats_device(0.0) if args.world
               else dv._f32(bones, dev))
    host_in = _timed(lambda: frame(vp, bones), dev, args.frames)
    dev_in = _timed(lambda: frame(vp_d, bones_d), dev, args.frames)
    rs.flush_overflow_checks()
    name = "render_frame_peeled" if args.peel else "render_frame"
    print(f"{name}, caps fixed, view+bones from host: {host_in!r} ms/frame")
    print(f"{name}, caps fixed, view+bones on device: {dev_in!r} ms/frame")

    clip = dv.vertex_stage(scene, vp_d, bones_d)
    if args.peel:
        stages, bins = _peel_stages(scene, clip, w, h, maxc, taps, args.peel,
                                    bones=bones_d, mipmap=args.mipmap,
                                    lighting=args.lighting)
    else:
        stages, bins = _single_stages(scene, clip, w, h, maxc, taps,
                                      bones=bones_d,
                                      mipmap=args.mipmap,
                                      lighting=args.lighting)
    stages = {"vertex_stage": lambda: dv.vertex_stage(scene, vp_d, bones_d),
              **stages}
    if args.world:
        stages = {"bone_mats_device (the palette on the device)":
                  lambda: case.bone_mats_device(12.0), **stages}
    print("stages ms: " + json.dumps(
        {k: _timed(fn, dev, args.frames) for k, fn in stages.items()}))
    rs.flush_overflow_checks()

    for name, (counts, glists) in bins.items():
        bits = sum(int(((glists >> g) & 1).sum()) for g in range(rs.G))
        print(f"binning{name}: chunks per tile max {int(counts.max())} "
              f"mean {float(counts.float().mean())!r}; live (tile, group) "
              f"pairs {bits}, i.e. {bits * rs.KG * rs.TILE_H * rs.TILE_W} "
              f"(triangle, pixel) pairs")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.prof_frames):
            frame(vp_d, bones_d)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rs.flush_overflow_checks()
    busy, span, top = _device_busy(prof, args.prof_frames)
    if top:
        print(f"profiler, {args.prof_frames} frames: device busy "
              f"{busy!r} ms/frame over a span of {span!r} ms/frame; idle "
              f"share against the unprofiled {dev_in!r} ms frame: "
              f"{1.0 - busy / dev_in!r}")
        for name, ms in top:
            print(f"  kernel {ms!r} ms/frame  {name}")
    else:
        print("profiler: no device events recorded; device busy time and "
              "idle share not measured")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
