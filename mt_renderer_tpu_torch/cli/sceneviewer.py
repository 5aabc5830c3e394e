"""sceneviewer — render every model in an archive as one composed scene.

The BASELINE config-5 workload: mount an ``.arc``, load every rModel it
contains (with materials/textures resolved through the resource manager),
lay the models out in a grid, composite the joint debug overlay, and
render on ``--device`` (default ``cuda``) through ``FrameEngine``, or
with ``--devices N`` band-split over N devices
(``parallel.tiles.render_frame_multichip``): the first N cards, or N
slots on the CPU under ``--device cpu``.

This goes beyond the reference (whose viewer shows one model at a time,
modelviewer.rs) to exercise the full-archive, multi-model path end to
end.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import dti as dti_mod
from ..app.camera import Camera
from ..formats.arc import ArchiveFile
from ..formats.mod import ModelFile
from ..formats.mrl import MaterialFile
from ..render import device
from ..resources import ResourceManager
from ..scene.model import build_draw_batch, merge_batches
from ..scene.overlay import DebugOverlay
from ._common import add_device_arg, load_shader2, \
    resolve_device


def build_archive_scene(rm: ResourceManager, archive_rel: str, shader2,
                        spacing: float = 3.0, overlay: bool = False):
    """All rModels in the archive → one merged DrawBatch laid out in a
    row. Returns (batch, model names)."""
    rm.add_archive(archive_rel)
    archive: ArchiveFile = list(rm._archives.values())[-1]
    model_dti = dti_mod.from_name("rModel")

    batches, names = [], []
    for info in archive.resources:
        if info.dti.hash != model_dti.hash:
            continue
        model = ModelFile(
            rm.get_resource(info.path, model_dti).read()
        )
        try:
            material = MaterialFile(
                rm.get_resource(info.path, dti_mod.from_name("rMaterial")).read(),
                shader2,
            )
        except FileNotFoundError:
            material = None
        batch = build_draw_batch(model, material, shader2, rm)
        batches.append(batch)
        names.append(info.path)

    if not batches:
        raise SystemExit(f"no rModel resources in {archive_rel}")

    # lay out in a row, then merge into one draw set
    merged = None
    ov = DebugOverlay()
    for i, b in enumerate(batches):
        off = np.array(
            [(i - (len(batches) - 1) / 2.0) * spacing, 0.0, 0.0], np.float32
        )
        b.positions = b.positions + off
        if overlay and b.joint_offsets is not None:
            for p in b.joint_offsets:
                ov.add_cube_at(np.asarray(p, np.float32) + off, scale=0.08)
        merged = b if merged is None else merge_batches(merged, b)
    ob = ov.batch()
    if ob is not None:
        merged = merge_batches(merged, ob)
    return merged, names


def main(argv=None):
    p = argparse.ArgumentParser(prog="sceneviewer", description=__doc__)
    p.add_argument("data_root", help="directory containing the archive")
    p.add_argument("archive", help="archive path relative to data root "
                                   "(without .arc extension)")
    p.add_argument("--out", default="scene.png")
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--overlay", action="store_true")
    p.add_argument("--backend", choices=["scan", "pallas"], default="pallas",
                   help="pallas: the binned tile raster; scan: every "
                        "triangle against every pixel (the oracle)")
    p.add_argument("--devices", type=int, default=0,
                   help="band-split the frame over this many devices (0 = "
                        "one): the first N cards, or N slots on the CPU "
                        "with --device cpu")
    add_device_arg(p)
    args = p.parse_args(argv)
    mesh = None
    if args.devices:
        from ..parallel.tiles import make_row_mesh

        # with fewer cards than asked, this raises, naming the count
        mesh = (make_row_mesh(args.devices, device="cpu")
                if torch.device(args.device).type == "cpu"
                else make_row_mesh(args.devices))
    dev = resolve_device(args.device) if mesh is None else mesh[0]

    rm = ResourceManager(args.data_root)
    shader2 = load_shader2(rm)
    batch, names = build_archive_scene(
        rm, args.archive, shader2, overlay=args.overlay
    )
    print(f"{len(names)} models: {names}")
    print(f"{batch.num_vertices} verts, {batch.num_triangles} tris, "
          f"{len(batch.textures)} textures")

    lo = batch.positions.min(0)
    hi = batch.positions.max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
    cam = Camera(position=center + [0, radius * 0.4, radius * 2.0],
                 pitch=-10.0, far=max(50.0, radius * 8))
    cam.aspect = args.width / args.height
    vp = np.asarray(cam.view_proj())

    scene = device.upload(batch, device=dev)
    if mesh is not None:
        from ..parallel.tiles import render_frame_multichip
        from ..render import raster

        color, _ = render_frame_multichip(
            scene, vp, None, mesh=mesh, width=args.width,
            height=args.height, backend=args.backend,
            packed=args.backend == "pallas")
        raster.flush_overflow_checks()
        print(f"rendered band-split over {args.devices} devices")
    else:
        from ..render.engine import FrameEngine

        eng = FrameEngine(scene, batch, width=args.width,
                          height=args.height, backend=args.backend)
        color, _ = eng.render(vp, None)
        eng.check(vp)

    from ..utils.png import write_png

    write_png(args.out, device.unpack_rgba(color) if args.backend == "pallas"
              else color.cpu().numpy())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
