"""Port vs reference: the app layer — input state, fly camera, frame
driver, frame-stream server, PNG encoder and the engine's interactive
knob.

The same seeded inputs and scripted events go through the JAX package's
``app`` and ``utils`` modules and the port's. Tolerances:
- input state, camera trajectory and view-projection (NumPy f32 in both),
  PNG bytes: equal;
- frames the manager drives through the binned raster (the JAX side in
  Pallas interpret mode): coverage exact, color under the golden rule
  (at most 0.3% of pixels with a channel off by more than 1; XLA
  contracts the plane sums into FMAs, the port rounds each op);
- the interactive engine's frame after a translucency spike: equal, bit
  for bit, to the dense-tap frame.
"""

import json
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from mt_renderer_tpu.app import camera as jcam
from mt_renderer_tpu.app import input_state as jinput
from mt_renderer_tpu.app import manager as jman
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo as jdemo
from mt_renderer_tpu.utils import png as jpng
from mt_renderer_tpu_torch.app import camera as tcam
from mt_renderer_tpu_torch.app import input_state as tinput
from mt_renderer_tpu_torch.app import manager as tman
from mt_renderer_tpu_torch.app.serve import FrameStreamServer
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render.engine import FrameEngine
from mt_renderer_tpu_torch.scene import demo as tdemo
from mt_renderer_tpu_torch.utils import png as tpng
from torch_threads import one_thread  # noqa: F401

S = 64
GOLDEN_SHARE = 0.003

# the trajectory of tests/test_app.py, then every key and a pitch clamp
EVENTS = [
    [("mouse", 10.0, 5.0)],
    [("key_down", "W")],
    [],
    [("key_up", "W"), ("mouse", -10.0, -5.0)],
    [],
    [("key_down", "A"), ("key_down", "S")],
    [("mouse", 3.5, -2000.0)],
    [("key_up", "A"), ("key_down", "D"), ("mouse", -7.25, 4000.0)],
    [("key_up", "S"), ("key_up", "D")],
]


def golden_share(got_u8, want_u8) -> float:
    """Share of pixels with a channel off by more than 1."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def _trajectory(cam_mod, input_mod, mgr_mod):
    """Dispatch ``EVENTS`` through a manager's input state and fly the
    camera once per frame, as the viewers' render hooks do."""
    mgr = mgr_mod.RendererAppManager(mgr_mod.RendererApp(), width=96,
                                     height=64)
    mgr.camera = cam_mod.Camera(position=[0.0, 0.5, 4.0], yaw=12.0)
    out = []
    for frame in EVENTS:
        for ev in frame:
            mgr.dispatch_event(ev)
        mgr.camera.update(mgr.input, mgr.aspect)
        mgr.camera.fly(mgr.input, dt=0.1, speed=2.0)
        out.append((mgr.camera.yaw, mgr.camera.pitch,
                    mgr.camera.position.copy(), mgr.camera.view_proj(),
                    mgr.input.frame_mouse_delta,
                    [mgr.input.has_key(k) for k in input_mod.Key]))
        mgr.input.next_frame()
    return out


def test_input_and_fly_camera_match_jax_bit_for_bit():
    got = _trajectory(tcam, tinput, tman)
    want = _trajectory(jcam, jinput, jman)
    assert len(got) == len(want) == len(EVENTS)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1]
        assert g[2].dtype == w[2].dtype == np.float32
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_array_equal(g[3], w[3])
        assert g[4] == w[4] and g[5] == w[5]
    # the clamp and the wrap were reached
    assert max(abs(g[1]) for g in got) == 89.0
    assert got[0][0] == pytest.approx(11.0)
    assert tcam.SENSITIVITY == jcam.SENSITIVITY


def test_input_state_key_flags_match_jax():
    assert [int(k) for k in tinput.Key] == [int(k) for k in jinput.Key]
    for mod in (tinput, jinput):
        s = mod.InputState()
        s.set_key(mod.Key.W | mod.Key.D)
        s.unset_key(mod.Key.W)
        assert not s.has_key(mod.Key.W) and s.has_key(mod.Key.D)
        s.add_mouse_movement(1.5, -2.0)
        s.add_mouse_movement(0.5, 1.0)
        assert s.frame_mouse_delta == (2.0, -1.0)
        s.next_frame()
        assert s.frame_mouse_delta == (0.0, 0.0)


def _fly_app(pkg: str):
    """The demo cube through each package's binned raster: orbiting in
    ``run_headless``, flown by ``camera.update``/``fly`` in
    ``run_interactive``; every frame's depth is kept for the coverage
    check."""
    base = tman.RendererApp if pkg == "torch" else jman.RendererApp

    class FlyApp(base):
        interactive = False

        def setup(self, mgr):
            if pkg == "torch":
                batch = tdemo.build_demo_batch(instances=1, skinned=False)
                self.scene = td.upload(batch, device="cpu")
            else:
                batch = jdemo.build_demo_batch(instances=1, skinned=False)
                self.scene = jd.upload(batch)
            self.depths = []

        def render(self, mgr):
            if self.interactive:
                mgr.camera.update(mgr.input, mgr.aspect)
                mgr.camera.fly(mgr.input, dt=0.1, speed=2.0)
            else:
                mgr.camera.yaw = 20.0 * mgr.frame_index
            dev = td if pkg == "torch" else jd
            color, depth = dev.render_frame(
                self.scene, mgr.camera.view_proj(), None, width=mgr.width,
                height=mgr.height, backend="pallas", packed=True)
            self.depths.append(np.asarray(depth))
            return color

    return FlyApp()


def _drive(pkg: str, how: str):
    app = _fly_app(pkg)
    mod = tman if pkg == "torch" else jman
    cam = (tcam if pkg == "torch" else jcam).Camera(position=[0, 0, 4.0])
    mgr = mod.RendererAppManager(app, width=S, height=S, camera=cam)
    frames = []
    if how == "headless":
        mgr.run_headless(frames=3, on_frame=lambda i, f: frames.append(f))
    else:
        app.interactive = True
        mgr.run_interactive(EVENTS[:5],
                            on_frame=lambda i, f: frames.append(f))
    return frames, app.depths, mgr


@pytest.fixture(scope="module")
def jax_frames():
    return {how: _drive("jax", how) for how in ("headless", "interactive")}


@pytest.mark.parametrize("how", ["headless", "interactive"])
def test_manager_frames_match_jax(jax_frames, how):
    got, got_z, mgr = _drive("torch", how)
    want, want_z, jmgr = jax_frames[how]
    assert len(got) == len(want) and mgr.frame_index == jmgr.frame_index
    for g, w, gz, wz in zip(got, want, got_z, want_z):
        assert g.shape == w.shape == (S, S, 4) and g.dtype == np.uint8
        np.testing.assert_array_equal(gz < 1.0, wz < 1.0)
        assert golden_share(g, w) <= GOLDEN_SHARE
    assert (got[0] != got[-1]).any()        # the camera moved
    assert mgr.frame_index == len(got)


def test_to_rgba_unpacks_the_packed_frame():
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    rgba[0, 0, 3] = 255                      # bit 31 set
    packed = torch.from_numpy(rgba.copy().view(np.int32)[..., 0])
    np.testing.assert_array_equal(tman._to_rgba(packed), rgba)
    np.testing.assert_array_equal(tman._to_rgba(torch.from_numpy(rgba)),
                                  rgba)
    np.testing.assert_array_equal(
        tman._to_rgba(rgba.view(np.uint32)[..., 0]), rgba)


def test_dispatch_rejects_unknown_event():
    mgr = tman.RendererAppManager(tman.RendererApp(), width=8, height=8)
    with pytest.raises(ValueError):
        mgr.dispatch_event(("scroll", 1.0))
    with pytest.raises(KeyError):
        mgr.dispatch_event(("key_down", "Q"))


def test_headless_png_output_matches_jax(tmp_path):
    class App:
        def setup(self, mgr):
            self.rng = np.random.default_rng(11)

        def render(self, mgr):
            return self.rng.integers(0, 256, (mgr.height, mgr.width, 4),
                                     dtype=np.uint8)

        def post_render(self, mgr):
            pass

    for name, mod in (("t", tman), ("j", jman)):
        mgr = mod.RendererAppManager(App(), width=12, height=9)
        mgr.run_headless(frames=2, out_path=str(tmp_path / name / "f_{i}.png"))
        mgr.run_headless(frames=1, out_path=str(tmp_path / name / "last.png"))
    for f in ("f_0.png", "f_1.png", "last.png"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


@pytest.mark.parametrize("shape", [(9, 13, 4), (16, 5, 3), (7, 11)])
@pytest.mark.parametrize("level", [1, 6])
def test_encode_png_bytes_match_jax(shape, level):
    rng = np.random.default_rng(sum(shape) + level)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] //= 16               # some runs to compress
    assert tpng.encode_png(img, level=level) == \
        jpng.encode_png(img, level=level)


def test_write_png_matches_jax(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (6, 10, 4), np.uint8)
    tpng.write_png(tmp_path / "t.png", img)
    jpng.write_png(tmp_path / "j.png", img)
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


def test_interactive_engine_checks_every_frame():
    batch = tdemo.build_demo_batch(instances=1, skinned=False)
    scene = td.upload(batch, device="cpu")
    assert FrameEngine(scene, batch, width=S, height=S,
                       interactive=True).check_every == 1
    assert FrameEngine(scene, batch, width=S, height=S).check_every == 16
    assert FrameEngine(scene, batch, width=S, height=S, interactive=True,
                       check_every=4).check_every == 4


def test_translucency_spike_recovers_within_one_frame():
    """An interactive engine flushes the overflow queue every frame: a
    translucency spike its cap guard cannot see (it bounds only the
    single-layer liveness) drops translucent texture for one displayed
    frame, and the next frame equals the dense-tap frame bit for bit
    (the JAX package's tests/test_engine.py holds its engine to the
    same)."""
    w, h = 256, 128
    batch = tdemo.make_translucent(
        tdemo.build_demo_batch(instances=16, skinned=True), 16,
        fraction=0.5)
    scene = td.upload(batch, device="cpu")
    vp = np.asarray(tdemo.demo_camera(16, w, h).view_proj())
    bones = tdemo.demo_bone_mats(0.3)
    eng = FrameEngine(scene, batch, width=w, height=h, peel=3,
                      interactive=True)
    eng.render(vp, bones)                    # size normally
    eng.tap_tiles = (1, 1)                   # the spike
    eng._tap_bound = 10 ** 9                 # keep the guard quiet
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        eng.render(vp, bones)                # drops texture, flushes
    assert eng.recoveries >= 1
    assert eng.tap_tiles[0] > 1 and eng.tap_tiles[1] > 1
    got, _ = eng.render(vp, bones)           # the next displayed frame
    want, _ = td.render_frame_peeled(
        scene, vp, bones, width=w, height=h, layers=3, peel_mode="split",
        maxc=eng.maxc, packed=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_frame_stream_server_stream_and_events():
    """The HTTP frontend on 127.0.0.1, port 0: the page, a PNG frame,
    events routed into the input state, the stats; the render loop owns
    its thread and stops cleanly."""
    from mt_renderer_tpu_torch.app.input_state import Key

    class App(tman.RendererApp):
        def setup(self, mgr):
            pass

        def render(self, mgr):
            # the frame encodes the live input state: W held -> white
            v = 255 if mgr.input.has_key(Key.W) else 0
            f = np.full((8, 8, 4), v, np.uint8)
            f[..., 3] = 255
            return torch.from_numpy(f)

    mgr = tman.RendererAppManager(App(), width=8, height=8)
    srv = FrameStreamServer(mgr, port=0)
    t = threading.Thread(target=srv.serve, kwargs={"fps_cap": 200.0},
                         daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.port}"
    white = tpng.encode_png(np.full((8, 8, 4), 255, np.uint8), level=1)
    try:
        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"/stream" in page
        png = urllib.request.urlopen(f"{base}/frame.png", timeout=10).read()
        assert png.startswith(b"\x89PNG")
        req = urllib.request.Request(
            f"{base}/event", data=b'[["key_down","W"]]', method="POST")
        assert json.loads(urllib.request.urlopen(
            req, timeout=10).read())["queued"] == 1
        deadline = time.time() + 10
        while time.time() < deadline:
            png = urllib.request.urlopen(f"{base}/frame.png",
                                         timeout=10).read()
            if png == white:
                break
            time.sleep(0.02)
        else:
            raise AssertionError("W keypress never reached the frame")
        bad = urllib.request.Request(f"{base}/event", data=b"{not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(bad, timeout=10)
        stats = json.loads(urllib.request.urlopen(
            f"{base}/stats", timeout=10).read())
        assert stats["frames"] > 0 and stats["width"] == 8
    finally:
        srv.stop()
        t.join(timeout=10)
    assert not t.is_alive()
