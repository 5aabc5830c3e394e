"""modelviewer — the flagship viewer (headless: renders orbit frames).

Reference contract (``src/bin/modelviewer.rs:74-136``):
``modelviewer <data-root> <character.prp>``. The character XFS names the
model resource (``mpModel``) and per-part visibility (``PartsDisp``); the
shader set loads from ``custom_shaders/CustomShaderPackage``. The
reference opens a fly-camera window; headless here renders ``--frames``
orbit frames to PNG, with the joint-cube debug overlay available via
``--overlay`` (model.rs:309-315). Frames render on ``--device`` (default
``cuda``) through ``FrameEngine``: the binned raster K1, and K2 with
``--peel``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dti as dti_mod
from ..app.camera import Camera
from ..app.manager import RendererApp, RendererAppManager
from ..formats.mod import ModelFile
from ..formats.mrl import MaterialFile
from ..render import device
from ..resources import ResourceManager
from ..scene.model import Model, merge_batches
from ..scene.overlay import DebugOverlay
from ._common import add_device_arg, load_shader2, \
    resolve_device


def load_character(rm: ResourceManager, prp_path: str):
    """character .prp → (model path, parts_disp list)."""
    from ..formats.xfs import deserialize, strip_prpz

    with open(prp_path, "rb") as f:
        root = deserialize(strip_prpz(f.read()))
    mp = root.get_prop("mpModel")
    if not mp:
        raise ValueError(f"{prp_path}: no mpModel property")
    # dynamic custom prop: list of [type name, resource path]
    model_path = mp[0][1] if isinstance(mp[0], (list, tuple)) else str(mp[0])
    parts = root.get_prop("PartsDisp") or []
    return model_path.replace("\\", "/"), [bool(x) for x in parts]


def _engine(app, mgr, scene, batch):
    """The production frame engine for this app's current scene and the
    manager's size — sized caps + overflow recovery, the same engine the
    smoke run times (render/engine.py)."""
    from ..render.engine import FrameEngine

    e = getattr(app, "_eng", None)
    if (e is None or e.scene is not scene
            or (e.width, e.height) != (mgr.width, mgr.height)):
        # interactive=True: the app loop reads every frame back
        # (app/manager.py), so the per-frame overflow flush is free and
        # a translucency spike recovers within ONE displayed frame
        app._eng = e = FrameEngine(
            scene, batch, width=mgr.width, height=mgr.height,
            backend=app.backend, mipmap=app.mipmap, lighting=app.lighting,
            peel=app.peel,
            peel_mode=("split" if app.backend == "pallas" else "ml"),
            interactive=True)
    return e


def _maybe_hud(app, mgr, color, extra: str = ""):
    """Composite the stats/GMD HUD band when ``--hud`` asked for it
    (app.hud.Hud over scene.gui — the config-5 GUI composite)."""
    if not getattr(app, "show_hud", False):
        return color
    if app._hud is None:
        from ..app.hud import Hud

        app._hud = Hud(mgr.width, gmd_path=app.hud_gmd,
                       gmd_label=app.hud_label)
    return app._hud.apply(mgr, color, extra=extra)


def _tag(app, what: str) -> str:
    return f"{what} peel{app.peel}" if app.peel else what


class ModelViewerApp(RendererApp):
    backend = "pallas"
    show_hud = False
    hud_gmd = None
    hud_label = None
    _hud = None

    def __init__(self, data_root: str, prp_path: str, overlay: bool = False,
                 sdl_path: str | None = None, device="cuda"):
        self.data_root = data_root
        self.prp_path = prp_path
        self.show_overlay = overlay
        self.sdl_path = sdl_path
        self.device = device
        self.animator = None
        self.mipmap = False
        self.lighting = False
        self.peel = 0
        self.overlay = DebugOverlay()

    def setup(self, mgr: RendererAppManager) -> None:
        rm = ResourceManager(self.data_root)
        shader2 = load_shader2(rm)
        model_path, parts_disp = load_character(rm, self.prp_path)
        print(f"model: {model_path}  parts_disp: {parts_disp}")

        model_res = rm.get_resource(model_path, dti_mod.from_name("rModel"))
        model_file = ModelFile(model_res.read())
        try:
            mat_res = rm.get_resource(model_path, dti_mod.from_name("rMaterial"))
            material = MaterialFile(mat_res.read(), shader2)
        except FileNotFoundError:
            material = None
        self.model = Model(model_file, material, shader2, rm,
                           parts_disp=parts_disp or None)
        b = self.model.batch
        print(f"{b.num_vertices} verts, {b.num_triangles} tris, "
              f"{len(b.textures)} textures, skinned={b.skinned}")

        # frame the model from its AABB
        lo = b.positions.min(0) if b.num_vertices else np.zeros(3)
        hi = b.positions.max(0) if b.num_vertices else np.ones(3)
        center = (lo + hi) / 2
        radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
        mgr.camera = Camera(
            position=center + [0, 0, radius * 2.4],
            far=max(50.0, radius * 10),
        )
        mgr.camera.aspect = mgr.aspect
        self._center = center
        self._radius = radius

        if self.sdl_path:
            from ..formats.sdl import SchedulerFile
            from ..scene.animation import BoneAnimator, Timeline

            with open(self.sdl_path, "rb") as f:
                timeline = Timeline(SchedulerFile(f.read()))
            sk = self.model.skeleton
            if sk is not None:
                self.animator = BoneAnimator(timeline, sk)
                self._duration = max(timeline.duration, 1)
                print(f"animation: {len(self.animator.params)} bone tracks, "
                      f"{self._duration} frames")
        self._rebuild()

    def _rebuild(self):
        batch = self.model.batch
        if self.show_overlay:
            self.overlay.clear()
            for pos in self.model.joint_world_positions():
                self.overlay.add_cube_at(pos, scale=self._radius * 0.02)
            ob = self.overlay.batch()
            if ob is not None:
                batch = merge_batches(batch, ob)
        self._batch = batch
        # budget-aware auto pool: trilinear viewers ride the tri pool
        # when it fits the device budget, degrading to quad/narrow under
        # memory pressure instead of running out of memory
        self.scene = device.upload(batch, pool_mode="auto",
                                   mipmap=self.mipmap, device=self.device)
        self.bones = np.tile(np.eye(4, dtype=np.float32),
                             (self.scene.num_joints, 1, 1))

    interactive = False

    def render(self, mgr: RendererAppManager):
        if self.interactive:
            # fly camera: mouse-look + WASD, event-driven
            # (renderer_app_manager.rs:215-269 / camera.rs:49-59)
            mgr.camera.update(mgr.input, mgr.aspect)
            mgr.camera.fly(mgr.input, dt=max(mgr.frame_time, 1 / 60),
                           speed=self._radius)
        else:
            # orbit: one slow turn around the model
            ang = np.radians(mgr.frame_index * 6.0)
            r = self._radius * 2.4
            mgr.camera.position = self._center + np.array(
                [np.sin(ang) * r, 0.3 * r, np.cos(ang) * r], np.float32
            )
            mgr.camera.yaw = np.degrees(ang)
            mgr.camera.pitch = -12.0
        if self.animator is not None:
            # the palette is computed on the device and stays there
            t = (mgr.frame_index * 2.0) % self._duration
            self.bones = self.animator.bone_mats_device(np.float32(t),
                                                        self.scene.device)
        # the production engine: auto-sized binning/tap caps + overflow
        # recovery (with peel: the split OIT engine — correct
        # back-to-front compositing regardless of draw order)
        color, _ = _engine(self, mgr, self.scene, self._batch).render(
            mgr.camera.view_proj(), self.bones)
        return _maybe_hud(self, mgr, color,
                          extra=_tag(self, self.scene.device.type))


class DemoWorldApp(RendererApp):
    """Asset-free stand-in for a loaded archive: the synthetic
    archive-world scene (scene/world.py) — lets ``--serve`` demo the
    live viewer (and the orbit render) without any game data. The
    characters' palette is computed on the device each frame
    (``bone_mats_device`` and ``bone_palette``), as ``entry.world_case``
    poses them."""

    interactive = False
    backend = "pallas"
    mipmap = True
    lighting = False
    peel = 0
    show_hud = False
    hud_gmd = None
    hud_label = None
    _hud = None

    def __init__(self, buildings: int = 40, device="cuda"):
        self.buildings = buildings
        self.device = device

    def setup(self, mgr: RendererAppManager) -> None:
        from ..scene import world

        self.world = world.build_world(buildings=self.buildings)
        print(f"world: {self.world.info}")
        self.scene = device.upload(self.world.batch, pool_mode="auto",
                                   mipmap=self.mipmap, device=self.device)
        self.anim = self.world.animator()
        self._dur = max(self.world.timeline.duration, 1)
        mgr.camera = world.world_camera(mgr.width, mgr.height,
                                        buildings=self.buildings)
        self._base = np.asarray(mgr.camera.position, np.float32).copy()
        self._radius = float(np.linalg.norm(self._base))

    def render(self, mgr: RendererAppManager):
        if self.interactive:
            mgr.camera.update(mgr.input, mgr.aspect)
            mgr.camera.fly(mgr.input, dt=max(mgr.frame_time, 1 / 60),
                           speed=self._radius * 0.2)
        else:
            mgr.camera.yaw = 8.0 + 10.0 * np.sin(mgr.frame_index * 0.1)
        bones = self.world.bone_palette(self.anim.bone_mats_device(
            np.float32((2.0 * mgr.frame_index) % self._dur),
            self.scene.device))
        color, _ = _engine(self, mgr, self.scene,
                           self.world.batch).render(
            mgr.camera.view_proj(), bones)
        return _maybe_hud(self, mgr, color, extra=_tag(self, "world"))


def main(argv=None):
    p = argparse.ArgumentParser(prog="modelviewer", description=__doc__)
    p.add_argument("data_root", nargs="?", default=None,
                   help="game data root directory")
    p.add_argument("prp_path", nargs="?", default=None,
                   help="character .prp file path")
    p.add_argument("--demo", type=int, default=None, metavar="BUILDINGS",
                   help="view the synthetic archive world instead of "
                        "loading assets (scene/world.py)")
    p.add_argument("--out", default="frame_{i}.png",
                   help="output PNG path ({i} = frame index)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--overlay", action="store_true",
                   help="draw joint debug cubes")
    p.add_argument("--backend", choices=["scan", "pallas"], default="pallas",
                   help="pallas: the binned tile raster; scan: every "
                        "triangle against every pixel (the oracle, "
                        "O(triangles x pixels); peels with 'ml')")
    p.add_argument("--sdl", default=None,
                   help="scheduler (.sdl) file animating the bone palette")
    p.add_argument("--mipmap", action="store_true",
                   help="trilinear mipmapped minification")
    p.add_argument("--lighting", action="store_true",
                   help="directional lambert shading (needs normals)")
    p.add_argument("--peel", type=int, default=0, metavar="L",
                   help="L-layer order-independent transparency "
                        "(split OIT engine)")
    p.add_argument("--hud", action="store_true",
                   help="composite a stats HUD band (fps/frame/size) "
                        "over the frame — the 2D GUI pass "
                        "(scene/gui.py; BASELINE config 5)")
    p.add_argument("--hud-gmd", default=None, metavar="GMD",
                   help="also draw a message from this .gmd file in "
                        "the HUD band")
    p.add_argument("--hud-label", default=None, metavar="LABEL",
                   help="GMD label to show (default: first message)")
    p.add_argument("--events", default=None,
                   help="JSON event script for the fly camera: a list of "
                        "per-frame event lists, e.g. "
                        '[[["mouse",10,0]],[["key_down","W"]],[]]')
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="serve a live fly-camera viewer over HTTP "
                        "(open http://HOST:PORT/ and click the frame; "
                        "the headless analog of the reference's window, "
                        "renderer_app_manager.rs:202-272)")
    p.add_argument("--serve-host", default="127.0.0.1")
    p.add_argument("--serve-frames", type=int, default=None,
                   help="stop the server after N frames (smoke tests)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.demo is not None:
        app = DemoWorldApp(buildings=args.demo, device=dev)
        app.backend = args.backend
        app.peel = args.peel
    elif args.data_root is None or args.prp_path is None:
        p.error("data_root and prp_path are required (or use --demo)")
    else:
        app = ModelViewerApp(args.data_root, args.prp_path,
                             overlay=args.overlay, sdl_path=args.sdl,
                             device=dev)
        app.backend = args.backend
        app.mipmap = args.mipmap
        app.lighting = args.lighting
        app.peel = args.peel
    app.show_hud = args.hud or args.hud_gmd is not None
    app.hud_gmd = args.hud_gmd
    app.hud_label = args.hud_label
    mgr = RendererAppManager(app, width=args.width, height=args.height)
    if args.serve is not None:
        from ..app.serve import FrameStreamServer

        app.interactive = True
        srv = FrameStreamServer(mgr, host=args.serve_host, port=args.serve)
        print(f"serving live viewer on http://{args.serve_host}:{srv.port}/")
        srv.serve(max_frames=args.serve_frames)
        print(f"served {mgr.frame_index} frame(s), last frame_time="
              f"{mgr.frame_time * 1000:.1f}ms")
        return mgr
    if args.events:
        import json

        with open(args.events) as f:
            event_frames = [[tuple(ev) for ev in frame]
                            for frame in json.load(f)]
        app.interactive = True
        mgr.run_interactive(event_frames, out_path=args.out)
        n = len(event_frames)
    else:
        mgr.run_headless(frames=args.frames, out_path=args.out)
        n = args.frames
    print(f"rendered {n} frame(s), last frame_time="
          f"{mgr.frame_time * 1000:.1f}ms")
    return mgr


if __name__ == "__main__":
    main()
