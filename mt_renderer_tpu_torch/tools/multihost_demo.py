"""Multi-process band-split render check — one process of N.

Forms a ``torch.distributed`` gloo group, renders the demo
scene band-split over the group (``parallel.multihost``), one band per
rank, and asserts that this rank's rows equal, bit for bit, the same
rows of a single-device frame rendered in this process.

Run one per process, with the same arguments except ``--proc``:

    python -m mt_renderer_tpu_torch.tools.multihost_demo --proc I \\
        --nproc N [--coordinator 127.0.0.1:9911 | file:///path/rdv] \\
        [--device cuda | cpu] [--width 512 --height 192] \\
        [--peel L] [--mipmap] [--setup-shard] [--geomsplit] [--gather K]

Gloo takes CUDA tensors for its ``all_reduce``, so several ranks may
share one card. Exits 0 and prints ``MULTIHOST OK`` in every process.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _check_rows(band, want, what: str, proc: int) -> int:
    """Hold this rank's rows (``multihost.local_rows``) to ``want``'s →
    the rows checked."""
    from ..parallel import multihost

    checked = 0
    for r0, rows in multihost.local_rows(band, want.shape[0]):
        np.testing.assert_array_equal(
            rows, want[r0:r0 + rows.shape[0]],
            err_msg=f"proc {proc}: {what} rows from {r0} differ")
        checked += rows.shape[0]
    return checked


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--proc", type=int, required=True)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--coordinator", default="127.0.0.1:9911",
                   help="host:port of rank 0, or a tcp:// or file:// URL")
    p.add_argument("--device", default="cuda",
                   help="torch device of this rank (default: cuda; no "
                        "fallback: pass --device cpu to render there)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--instances", type=int, default=4)
    p.add_argument("--subdiv", type=int, default=0)
    p.add_argument("--peel", type=int, default=0,
                   help="also check an L-layer banded split peel")
    p.add_argument("--mipmap", action="store_true",
                   help="also check a banded trilinear frame")
    p.add_argument("--setup-shard", action="store_true",
                   help="also check the band split with the sharded setup")
    p.add_argument("--geomsplit", action="store_true",
                   help="also check the geometry split over the group")
    p.add_argument("--gather", type=int, default=0, metavar="K",
                   help="check the full-frame gather and time K of them")
    args = p.parse_args(argv)

    from ..cli._common import resolve_device
    from ..entry import demo_case
    from ..parallel import multihost
    from ..parallel.tiles import render_frame_geomsplit
    from ..render import device as dv
    from ..render import raster as rs

    dev = resolve_device(args.device)
    dist = multihost.init(args.coordinator, args.nproc, args.proc)
    w, h = args.width, args.height
    print(f"proc {args.proc}/{args.nproc}: gloo group on {dev}", flush=True)
    case = demo_case(dev, instances=args.instances, subdiv=args.subdiv,
                     width=w, height=h)
    vp, bones = case.view_proj(), case.bone_mats(0.5)
    maxc = dv.auto_maxc(case.batch, vp, bones, width=w, height=h)
    kw = dict(width=w, height=h, maxc=maxc, packed=True)

    color, depth = multihost.render_frame_multihost(case.scene, vp, bones,
                                                    **kw)
    ref, ref_d = dv.render_frame(case.scene, vp, bones, **kw)
    ref, ref_d = ref.cpu().numpy(), ref_d.cpu().numpy()
    checked = _check_rows(color, ref, "packed", args.proc)
    _check_rows(depth, ref_d, "depth", args.proc)
    cover = [float(np.mean(rows < 1.0))
             for _, rows in multihost.local_rows(depth, h)]
    print(f"proc {args.proc}: {checked} rows from {color.row0} equal to "
          f"the single-device frame; band coverage {cover}", flush=True)

    if args.peel:
        glass = demo_case(dev, instances=args.instances, subdiv=args.subdiv,
                          width=w, height=h, translucent=True)
        pkw = dict(kw, maxc=dv.auto_maxc(glass.batch, vp, bones, width=w,
                                         height=h))
        pc, _ = multihost.render_frame_multihost(
            glass.scene, vp, bones, peel_layers=args.peel, **pkw)
        pref, _ = dv.render_frame_peeled(glass.scene, vp, bones,
                                         layers=args.peel,
                                         peel_mode="split", **pkw)
        _check_rows(pc, pref.cpu().numpy(), f"peel{args.peel}", args.proc)
        print(f"proc {args.proc}: peel{args.peel} rows equal", flush=True)

    if args.mipmap:
        mc, _ = multihost.render_frame_multihost(case.scene, vp, bones,
                                                 mipmap=True, **kw)
        mref, _ = dv.render_frame(case.scene, vp, bones, mipmap=True, **kw)
        _check_rows(mc, mref.cpu().numpy(), "mipmap", args.proc)
        print(f"proc {args.proc}: mipmap rows equal", flush=True)

    if args.setup_shard:
        sc, sd = multihost.render_frame_multihost(case.scene, vp, bones,
                                                  setup_shard=True, **kw)
        _check_rows(sc, ref, "setup_shard", args.proc)
        _check_rows(sd, ref_d, "setup_shard depth", args.proc)
        print(f"proc {args.proc}: setup_shard rows equal", flush=True)

    if args.geomsplit:
        gc, gd = render_frame_geomsplit(case.scene, vp, bones,
                                        group=multihost.global_row_mesh(),
                                        **kw)
        np.testing.assert_array_equal(gc.cpu().numpy(), ref)
        np.testing.assert_array_equal(gd.cpu().numpy(), ref_d)
        print(f"proc {args.proc}: geometry-split frame equal", flush=True)

    if args.gather:
        full = multihost.gather_full_frame(color, h)
        np.testing.assert_array_equal(full, ref)
        np.testing.assert_array_equal(
            multihost.gather_full_frame(depth, h), ref_d)
        t0 = time.perf_counter()
        for _ in range(args.gather):
            multihost.gather_full_frame(color, h)
        dt = (time.perf_counter() - t0) / args.gather
        mb = full.nbytes / 2**20
        print(f"proc {args.proc}: full-frame gather equal to the "
              f"single-device frame; {mb:.2f} MB in {dt * 1e3:.3f} ms a "
              f"gather (host clock, gloo on {dev.type})",
              flush=True)

    rs.flush_overflow_checks()
    if rs.OVERFLOW_EVENTS:
        raise AssertionError(f"proc {args.proc}: {rs.OVERFLOW_EVENTS} "
                             "overflow events")
    dist.barrier()
    dist.destroy_process_group()
    print("MULTIHOST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
