"""Port vs reference: the viewer CLIs on the fixture tree.

Both packages write the fixture tree (byte for byte the same), then run
``modelviewer`` (``--overlay``, ``--sdl``, ``--peel 2``, ``--mipmap
--lighting``, ``--events``, ``--serve``, ``--demo``), ``textureviewer``
(raw and YCbCr, ``--hud``, ``--serve``) and ``sceneviewer`` with the
same arguments; the port with ``--device cpu``, the JAX package through
its Pallas kernels in interpret mode. Every frame that ``FrameEngine``
renders is recorded in both (color and depth) by wrapping its
``render``.

Tolerances: the fixture files equal; rendered frames with coverage
(depth < 1) exact and color under the golden rule (at most 0.3% of
pixels with a channel off by more than 1); the texture view within 1
code per channel, every differing channel a rounding tie, and the
port's equal to the NumPy f32 evaluation
(``tests/test_torch_texture_view.py``); the HUD's fps line changes
every run, so a frame drawn with ``--hud`` is compared below its band.
"""

import contextlib
import json
import struct
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from mt_renderer_tpu import fixtures as jfix
from mt_renderer_tpu.app import manager as jman
from mt_renderer_tpu.cli import modelviewer as jmv
from mt_renderer_tpu.cli import sceneviewer as jsv
from mt_renderer_tpu.cli import textureviewer as jtv
from mt_renderer_tpu.render import engine as jengine
from mt_renderer_tpu_torch import fixtures as tfix
from mt_renderer_tpu_torch.app import manager as tman
from mt_renderer_tpu_torch.cli import _common
from mt_renderer_tpu_torch.cli import modelviewer as tmv
from mt_renderer_tpu_torch.cli import sceneviewer as tsv
from mt_renderer_tpu_torch.cli import textureviewer as ttv
from mt_renderer_tpu_torch.render import engine as tengine
from torch_threads import one_thread  # noqa: F401

S = 64
GOLDEN_SHARE = 0.003
SKINNED = "chara/fixture_character_skinned.chr"
FIXTURE_FILES = [
    "chara/fixture_character.chr", "chara/fixture_character_skinned.chr",
    "custom_shaders/CustomShaderPackage.mfx",
    "custom_shaders/CustomShaderPackage.spkg", "fixture_scene.arc",
    "gui/fixture_messages.gmd", "model/fixture_albedo.tex",
    "model/fixture_albedo_bc1.tex", "model/fixture_albedo_bc7.tex",
    "model/fixture_cube.mod", "model/fixture_cube.mrl",
    "model/fixture_cube_rich.mod", "model/fixture_cube_rich.mrl",
    "model/fixture_cube_skinned.mod", "model/fixture_cube_skinned.mrl",
    "motion/fixture_bones.sdl", "motion/fixture_timeline.sdl",
]
EVENTS = [[["mouse", 10, 0]], [["key_down", "W"]], [["key_down", "D"]],
          [["key_up", "W"], ["mouse", -4, 6]]]


def read_png(path) -> np.ndarray:
    """Decode the PNGs ``utils.png`` writes (8-bit, filter 0 rows)."""
    data = Path(path).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, _, color, _, _, _ = hdr
    c = {2: 3, 6: 4}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c)


def golden_share(got_u8, want_u8) -> float:
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextlib.contextmanager
def recording(engine_cls):
    """Record every (color, depth) that ``engine_cls.render`` returns."""
    out = []
    orig = engine_cls.render

    def render(self, view_proj, bone_mats=None):
        color, depth = orig(self, view_proj, bone_mats)
        out.append((_host(color), _host(depth)))
        return color, depth

    engine_cls.render = render
    try:
        yield out
    finally:
        engine_cls.render = orig


@contextlib.contextmanager
def fixed_clock(manager_mod, step: float = 0.01):
    """A manager clock that advances ``step`` seconds per read: the fly
    camera moves ``speed * max(frame_time, 1/60)`` a frame, and a wall
    clock would give the two packages different trajectories."""
    t = [0.0]

    def perf_counter():
        t[0] += step
        return t[0]

    orig = manager_mod.time
    manager_mod.time = types.SimpleNamespace(perf_counter=perf_counter)
    try:
        yield
    finally:
        manager_mod.time = orig


def assert_frames_match(got, want):
    """Coverage exact, color under the golden rule."""
    assert len(got) == len(want) > 0
    for (gc, gz), (wc, wz) in zip(got, want):
        assert gc.shape == wc.shape
        np.testing.assert_array_equal(gz < 1.0, wz < 1.0)
        g = gc.view(np.uint8).reshape(*gc.shape, 4)
        w = wc.view(np.uint8).reshape(*wc.shape, 4)
        assert golden_share(g, w) <= GOLDEN_SHARE


# each run's CLI arguments after the data root ({root} is filled in
# per package)
MODELVIEWER_RUNS = {
    "overlay": ["{root}/" + SKINNED, "--overlay", "--frames", "2"],
    "sdl": ["{root}/" + SKINNED, "--sdl", "{root}/motion/fixture_bones.sdl",
            "--frames", "2"],
    "peel2": ["{root}/chara/fixture_character.chr", "--peel", "2"],
    "mip_light": ["{root}/" + SKINNED, "--mipmap", "--lighting"],
    "events": ["{root}/" + SKINNED, "--events", "{root}/events.json"],
    "serve": ["{root}/chara/fixture_character.chr", "--serve", "0",
              "--serve-frames", "2"],
    "demo": ["--demo", "4", "--frames", "2"],
}
TEXTUREVIEWER_RUNS = {
    "raw": ["model/fixture_albedo.tex", "--raw"],
    "ycbcr": ["model/fixture_albedo.tex"],
    "bc7_hud": ["model/fixture_albedo_bc7.tex", "--hud"],
    "bc1_wide": ["model/fixture_albedo_bc1.tex", "--width", "96"],
}


def _mv_argv(name, root, out, device=None):
    args = [a.format(root=root) for a in MODELVIEWER_RUNS[name]]
    argv = args if name == "demo" else [str(root)] + args
    argv += ["--width", str(S), "--height", str(S), "--out",
             str(out / f"{name}_{{i}}.png")]
    return argv + (["--device", device] if device else [])


def _tv_argv(name, root, out, device=None):
    tex, *rest = TEXTUREVIEWER_RUNS[name]
    argv = [str(root / tex), *rest, "--out", str(out / f"{name}.png")]
    if "--width" not in rest:
        argv += ["--width", str(S)]
    argv += ["--height", str(S)]
    return argv + (["--device", device] if device else [])


def _run_all(pkg: str, root: Path, out: Path) -> dict:
    mv, tv, sv, eng, man = (
        (jmv, jtv, jsv, jengine.FrameEngine, jman) if pkg == "jax"
        else (tmv, ttv, tsv, tengine.FrameEngine, tman))
    device = None if pkg == "jax" else "cpu"
    res = {}
    for name in MODELVIEWER_RUNS:
        with recording(eng) as frames, fixed_clock(man):
            mv.main(_mv_argv(name, root, out, device))
        res["mv", name] = frames
    for name in TEXTUREVIEWER_RUNS:
        tv.main(_tv_argv(name, root, out, device))
    with recording(eng) as frames:
        sv.main([str(root), "fixture_scene", "--overlay", "--width", "96",
                 "--height", "48", "--out", str(out / "scene.png")]
                + (["--device", device] if device else []))
    res["sv"] = frames
    return res


def _tree(pkg: str, tmp: Path) -> Path:
    root = tmp / pkg / "data"
    (tfix if pkg == "torch" else jfix).write_fixture_tree(root)
    (root / "events.json").write_text(json.dumps(EVENTS))
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viewers")
    out = {}
    for pkg in ("jax", "torch"):
        root = _tree(pkg, tmp)
        (tmp / pkg / "out").mkdir()
        out[pkg] = dict(root=root, out=tmp / pkg / "out",
                        frames=_run_all(pkg, root, tmp / pkg / "out"))
    return out


@pytest.mark.parametrize("rel", FIXTURE_FILES)
def test_fixture_tree_is_byte_equal(runs, rel):
    t, j = runs["torch"]["root"], runs["jax"]["root"]
    assert (t / rel).read_bytes() == (j / rel).read_bytes()


def test_fixture_tree_has_the_same_files(runs):
    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and p.name != "events.json")

    assert files(runs["torch"]["root"]) == files(runs["jax"]["root"]) \
        == sorted(FIXTURE_FILES)


@pytest.mark.parametrize("name", list(MODELVIEWER_RUNS))
def test_modelviewer_matches_jax(runs, name):
    got, want = runs["torch"]["frames"]["mv", name], \
        runs["jax"]["frames"]["mv", name]
    assert_frames_match(got, want)
    if name == "serve":
        return                       # the server writes no PNG
    n = len(got)
    for i in range(n):
        g = read_png(runs["torch"]["out"] / f"{name}_{i}.png")
        w = read_png(runs["jax"]["out"] / f"{name}_{i}.png")
        assert g.shape == w.shape == (S, S, 4)
        assert golden_share(g, w) <= GOLDEN_SHARE
        np.testing.assert_array_equal(g, got[i][0].view(np.uint8).reshape(
            S, S, 4))
    if name in ("overlay", "events", "demo"):
        assert (got[0][0] != got[-1][0]).any()     # the view moved


@pytest.mark.parametrize("name", list(TEXTUREVIEWER_RUNS))
def test_textureviewer_matches_jax(runs, name):
    from mt_renderer_tpu_torch.formats.tex import TextureFile
    from test_torch_texture_view import view_f32, view_f64

    g = read_png(runs["torch"]["out"] / f"{name}.png")
    w = read_png(runs["jax"]["out"] / f"{name}.png")
    tex_rel, *rest = TEXTUREVIEWER_RUNS[name]
    tex = TextureFile((runs["torch"]["root"] / tex_rel).read_bytes())
    rgba = tex.decode_rgba8()
    width = int(rest[rest.index("--width") + 1]) if "--width" in rest else S
    ycbcr = "--raw" not in rest
    want = view_f32(rgba, width, S, ycbcr)
    exact = view_f64(rgba, width, S, ycbcr)
    assert g.shape == w.shape == want.shape == (S, width, 4)
    band = 0
    if "--hud" in rest:
        from mt_renderer_tpu_torch.app.hud import Hud

        band = Hud(S).overlay.canvas.height
        assert (g[:band] != want[:band]).any()          # the band drawn
    g, w, want, exact = g[band:], w[band:], want[band:], exact[band:]
    np.testing.assert_array_equal(g, want)
    d = np.abs(g.astype(np.int32) - w.astype(np.int32))
    assert d.max() <= 1
    tie = np.abs(exact - np.round(exact)) < 1e-3
    assert not (d > 0)[~tie].any()


def test_sceneviewer_matches_jax(runs):
    assert_frames_match(runs["torch"]["frames"]["sv"],
                        runs["jax"]["frames"]["sv"])
    g = read_png(runs["torch"]["out"] / "scene.png")
    w = read_png(runs["jax"]["out"] / "scene.png")
    assert g.shape == w.shape == (48, 96, 4)
    assert golden_share(g, w) <= GOLDEN_SHARE


def test_textureviewer_serves_frames(runs, capsys):
    root = runs["torch"]["root"]
    mgr = ttv.main([str(root / "model/fixture_albedo.tex"), "--raw",
                    "--hud", "--width", "48", "--height", "40", "--serve",
                    "0", "--serve-frames", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving texture view on http://127.0.0.1:" in out
    assert "served 2 frame(s)" in out and mgr.frame_index == 2


def test_viewers_refuse_cuda_without_a_card(runs, monkeypatch):
    """No fallback: the default ``--device cuda`` on a host without CUDA
    is an error that names the problem, before anything renders."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = runs["torch"]["root"]
    calls = [
        lambda: tmv.main(["--demo", "2", "--frames", "1"]),
        lambda: tmv.main([str(root), str(root / SKINNED)]),
        lambda: ttv.main([str(root / "model/fixture_albedo.tex")]),
        lambda: tsv.main([str(root), "fixture_scene"]),
    ]
    for call in calls:
        with pytest.raises(SystemExit, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit, match="no CUDA device"):
        _common.resolve_device("cuda:0")
    assert _common.resolve_device("cpu") == torch.device("cpu")


def test_scan_backend_and_devices_are_refused(runs, tmp_path):
    """``--backend scan``, once refused, renders in both viewers as the
    reference's does: modelviewer's peel through the scan backend's "ml"
    peel, sceneviewer's frame; each frame (the uint8 frame of the scan
    backend) under the golden rule against the JAX viewer's, coverage
    exact, and sceneviewer's PNG that frame. ``--devices N`` still asks
    for N cards."""
    frames = {}
    for pkg, mv, sv, eng in (("jax", jmv, jsv, jengine.FrameEngine),
                             ("torch", tmv, tsv, tengine.FrameEngine)):
        root, dev = runs[pkg]["root"], ["--device", "cpu"] * (pkg == "torch")
        with recording(eng) as got:
            mv.main([str(root), str(root / SKINNED), "--backend", "scan",
                     "--peel", "2", "--width", str(S), "--height", str(S),
                     "--out", str(tmp_path / f"{pkg}_mv.png")] + dev)
            sv.main([str(root), "fixture_scene", "--backend", "scan",
                     "--width", "96", "--height", "48", "--out",
                     str(tmp_path / f"{pkg}_sv.png")] + dev)
        frames[pkg] = got
    assert len(frames["torch"]) == len(frames["jax"]) == 2
    for (gc, gz), (wc, wz) in zip(frames["torch"], frames["jax"]):
        assert gc.dtype == np.uint8 and gc.shape == wc.shape
        np.testing.assert_array_equal(gz < 1.0, wz < 1.0)
        assert golden_share(gc, wc) <= GOLDEN_SHARE
        assert (gz < 1.0).any()
    np.testing.assert_array_equal(read_png(tmp_path / "torch_sv.png"),
                                  frames["torch"][1][0])
    root = runs["torch"]["root"]
    # --devices N asks for N cards, and names the count it found
    with pytest.raises(RuntimeError, match="0 visible"):
        tsv.main([str(root), "fixture_scene", "--devices", "2"])


def test_sceneviewer_devices_band_split_on_cpu_slots(runs, tmp_path):
    """``--devices 3 --device cpu`` band-splits the frame over three CPU
    slots: its PNG equals the single-device run's bit for bit."""
    root = runs["torch"]["root"]
    out = tmp_path / "scene3.png"
    tsv.main([str(root), "fixture_scene", "--overlay", "--width", "96",
              "--height", "48", "--out", str(out), "--devices", "3",
              "--device", "cpu"])
    np.testing.assert_array_equal(read_png(out),
                                  read_png(runs["torch"]["out"]
                                           / "scene.png"))
