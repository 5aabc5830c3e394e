"""Port vs reference: the served frame (``serving.py``) and K1 as a
custom op.

The port's ``export_render`` traces ``render_frame`` with
``torch.export`` (K1 as ``mtr::raster_fwd_tap`` or ``_mtap``), and
``load_render`` serves the deserialised program. On the CPU, at 64x64
(the skinned demo, 4 instances), with the quad pool and, mipmapped,
with the tri pool:

- the served frame equals the port's ``render_frame`` bit for bit
  (color and depth), from a ``DeviceScene`` or from NumPy leaves;
- against JAX ``render_frame(backend="pallas", packed=True)`` (Pallas in
  interpret mode) and against JAX's own served frame (its
  ``export_render`` runs on the CPU): coverage exact, at most 0.3% of
  pixels with a channel off by more than 1 (the golden rule: plane sums
  and the contraction round in another order than XLA's), depth within
  1e-5;
- ``torch.library.opcheck`` passes on both ops;
- the served frame's overflow counts equal ``_render_frame_core``'s and
  reach the deferred queue with the reference's default caps;
- ``backend="scan"``, a foreign ``platforms`` and leaves on another
  device raise;
- a CPU artifact never captures a CUDA graph: every request runs the
  program, under a profiler no ``serve.capture`` span opens and no
  ``serve.replays`` or ``serve.captures`` is counted, and its frames
  are ``render_frame``'s; the graph's key tells leaves apart by their
  memory and the view and the palette by their shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu import serving as jserving
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch import serving
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.utils import profiling
from torch_threads import one_thread  # noqa: F401

W = H = 64
GOLDEN_SHARE = 0.003
DEPTH_TOL = 1e-5
VIEWS = [(0.0, 0.5), (6.0, 1.1), (-9.0, 2.3)]     # (yaw offset, bone phase)


def golden_share(got_u8, want_u8) -> float:
    """Share of pixels with a channel off by more than 1."""
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def view(yaw: float, phase: float):
    cam = demo.demo_camera(4, W, H)
    cam.yaw += yaw
    return np.asarray(cam.view_proj()), demo.demo_bone_mats(phase)


@pytest.fixture(scope="module")
def batch():
    return demo.build_demo_batch(instances=4, skinned=True, subdiv=1)


@pytest.fixture(scope="module", params=[False, True], ids=["tap", "mip"])
def served(request, batch):
    """(mipmap, the port's CPU scene, its artifact) for the quad pool
    (tap) and the tri pool (mipmapped)."""
    mipmap = request.param
    scene = td.upload(batch, "tri" if mipmap else "quad", device="cpu")
    blob = serving.export_render(scene, width=W, height=H, mipmap=mipmap,
                                 platforms=["cpu"] if mipmap else None)
    return mipmap, scene, serving.load_render(blob)


def test_served_frame_equals_render_frame(served):
    mipmap, scene, art = served
    assert art.device == torch.device("cpu")
    leaves_np = [x.numpy() for x in serving.scene_leaves(scene)]
    for yaw, phase in VIEWS:
        vp, bones = view(yaw, phase)
        want, wdepth = td.render_frame(scene, vp, bones, width=W, height=H,
                                       mipmap=mipmap)
        for source in (scene, leaves_np):
            color, depth = art(source, vp, bones)
            assert color.dtype == torch.uint8
            assert tuple(color.shape) == (H, W, 4)
            assert torch.equal(color, want) and torch.equal(depth, wdepth)
        assert 0.05 < float((depth < 1.0).float().mean()) < 0.95
    tr.flush_overflow_checks()


def test_served_frame_matches_jax(served, batch):
    """Against JAX ``render_frame(backend="pallas", packed=True)`` and
    against JAX's own served frame, which equals it here."""
    mipmap, _, art = served
    js = jd.upload(batch, pool_mode="tri" if mipmap else "quad")
    jart = jserving.load_render(jserving.export_render(
        js, width=W, height=H, backend="pallas", mipmap=mipmap))
    vp, bones = view(*VIEWS[0])
    color, depth = art(serving.scene_leaves(
        td.upload(batch, "tri" if mipmap else "quad", device="cpu")),
        vp, bones)
    packed, wdepth = jd.render_frame(js, vp, bones, width=W, height=H,
                                     backend="pallas", packed=True,
                                     mipmap=mipmap)
    jcolor, jdepth = jart(js, jnp.asarray(vp), jnp.asarray(bones))
    np.testing.assert_array_equal(np.asarray(jcolor), jd.unpack_rgba(packed))
    np.testing.assert_array_equal(np.asarray(jdepth), np.asarray(wdepth))
    cov = np.asarray(wdepth) < 1.0
    np.testing.assert_array_equal(depth.numpy() < 1.0, cov)
    assert golden_share(color.numpy(), np.asarray(jcolor)) <= GOLDEN_SHARE
    assert np.abs(depth.numpy() - np.asarray(jdepth)).max() <= DEPTH_TOL
    pr.flush_overflow_checks()
    tr.flush_overflow_checks()


def test_served_graph_reaches_k1_through_its_op(served):
    mipmap, _, art = served
    want = "raster_fwd_mtap" if mipmap else "raster_fwd_tap"
    targets = [str(n.target) for n in art._program.graph.nodes
               if n.op == "call_function"]
    assert sum(want in t for t in targets) == 1
    assert not any("raster_fwd_ml" in t for t in targets)


@pytest.mark.parametrize("mode", tr.MODES)
@pytest.mark.parametrize("lit", [False, True])
def test_k1_ops_pass_opcheck(batch, mode, lit):
    scene = td.upload(batch, device="cpu")
    vp, bones = view(0.0, 0.5)
    cols, bbox = td.setup_packed_cols(scene, td.vertex_stage(scene, vp, bones),
                                      W, H, bone_mats=bones, lighting=lit)
    lists, glists, counts, _ = tr.prebin(cols, bbox, 0, 0, width=128,
                                         height=H)
    light = list(td._light_unit()) if lit else None
    torch.library.opcheck(tr.K1_OPS[mode], (cols, lists, glists, counts,
                                            [0, 0], 128, H, td.W_EPS, light))
    got = tr.raster_fwd(cols, lists, glists, counts, (0, 0), width=128,
                        height=H, w_eps=td.W_EPS, mode=mode,
                        light=None if light is None else tuple(light))
    want = tr.raster_fwd_reference(cols, lists, glists, counts, (0, 0),
                                   width=128, height=H, w_eps=td.W_EPS,
                                   mode=mode, light=light)
    assert len(got) == (4 if mode == "tap" else 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_served_overflow_counts_equal_the_frames(served):
    """The program's two counts equal ``_render_frame_core``'s, and the
    artifact queues them with the caps MAXC_DEFAULT (capped at the chunk
    count, as ``prebin`` caps it) and every tap row."""
    mipmap, scene, art = served
    vp, bones = view(0.0, 0.5)
    tr.flush_overflow_counts()
    *_, n_over, n_over_tap = art._step(serving.scene_leaves(scene),
                                       torch.as_tensor(vp),
                                       torch.as_tensor(bones))
    _, _, (w_over, w_tap) = td._render_frame_core(
        scene, vp, bones, width=W, height=H,
        clear_color=(255, 255, 255, 255), maxc=None, tap_tiles=None,
        mipmap=mipmap)
    assert torch.equal(n_over, w_over) and torch.equal(n_over_tap, w_tap)
    art(scene, vp, bones)
    counts = tr.flush_overflow_counts()
    nrows = (128 // tr.TILE_W) * (H // (td.SEG_PX // tr.TILE_W))
    assert sorted(counts.values()) == sorted([(0, tr.MAXC_DEFAULT),
                                              (0, nrows)])


def test_served_overflow_warns(served, monkeypatch):
    """Non-zero counts out of the program reach the queue and warn when
    it is flushed: a served frame's overflow is never silent."""
    _, scene, art = served
    step = art._step

    def over(*args):
        color, depth, _, _ = step(*args)
        return (color, depth, torch.tensor(3, dtype=torch.int32),
                torch.tensor(2, dtype=torch.int32))

    monkeypatch.setattr(art, "_step", over)
    # the module's event count is the process's: restore it afterwards
    before = tr.OVERFLOW_EVENTS
    monkeypatch.setattr(tr, "OVERFLOW_EVENTS", before)
    tr.flush_overflow_counts()
    art(scene, *view(0.0, 0.5))
    with pytest.warns(RuntimeWarning, match="exceeded cap"):
        tr.flush_overflow_checks()
    assert tr.OVERFLOW_EVENTS == before + 2


def test_export_refuses_scan_and_foreign_platforms(batch):
    """``backend="scan"``, once refused, exports: on a bc1 pool without
    mipmap (which the binned raster refuses) the served frame equals
    ``render_frame(backend="scan")`` bit for bit. The chunk loop unrolls
    into the program, so its size grows with the triangle count: at this
    size (384 padded triangles, 24 chunks of 16) it stays under 128 KB a
    chunk. Foreign platforms and the pallas bc1 tap frame still raise."""
    scene = td.upload(batch, device="cpu")
    bc1 = td.upload(batch, "bc1", device="cpu")
    blob = serving.export_render(bc1, width=W, height=H, backend="scan")
    chunks = bc1.tri_valid.shape[0] // td.DEFAULT_CHUNK
    assert chunks == 24 and len(blob) < chunks * 128 * 1024
    art = serving.load_render(blob)
    for yaw, phase in VIEWS[:2]:
        vp, bones = view(yaw, phase)
        got = art(bc1, vp, bones)
        want = td.render_frame(bc1, vp, bones, width=W, height=H,
                               backend="scan")
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool((want[1] < 1.0).any())
    for platforms in (["cuda"], ["tpu"], ["cpu", "cuda"]):
        with pytest.raises(ValueError, match="holds the scene's device"):
            serving.export_render(scene, width=W, height=H,
                                  platforms=platforms)
    with pytest.raises(ValueError, match="mipmap path"):
        serving.export_render(td.upload(batch, "bc1", device="cpu"),
                              width=W, height=H)


def test_artifact_refuses_leaves_on_another_device(served):
    _, scene, art = served
    vp, bones = view(0.0, 0.5)
    leaves = serving.scene_leaves(scene)
    moved = [leaves[0].to("meta")] + leaves[1:]
    with pytest.raises(ValueError, match="positions is on meta"):
        art(moved, vp, bones)
    with pytest.raises(ValueError, match="leaves"):
        art(leaves[:-1], vp, bones)


def test_a_cpu_artifact_never_captures(served, tmp_path):
    """Five requests on one scene, under a profiler: each runs the
    program (no graph, no ``serve.capture``, no ``serve.replays`` or
    ``serve.captures``), each frame ``render_frame``'s, and a frame held
    from one request is unchanged after the next."""
    mipmap, scene, art = served
    held = []
    with profiling.trace(str(tmp_path)):
        for k in range(5):
            vp, bones = view(*VIEWS[k % len(VIEWS)])
            color, depth = art(scene, vp, bones)
            want, wdepth = td.render_frame(scene, vp, bones, width=W,
                                           height=H, mipmap=mipmap)
            assert torch.equal(color, want) and torch.equal(depth, wdepth)
            held.append((color, color.clone()))
    assert art._graph is None and art.meta["backend"] == "pallas"
    assert all(torch.equal(a, b) for a, b in held)
    spans = profiling.span_totals()
    assert spans["serve.request"][0] == spans["serve.step"][0] == 5
    assert "serve.capture" not in spans
    counts = profiling.count_totals()
    assert "serve.replays" not in counts and "serve.captures" not in counts
    profiling.reset_spans()
    tr.flush_overflow_checks()


def test_the_graph_key_is_the_leaves_memory_and_the_input_shapes(served):
    """``_call_key``: the same leaves and shapes give one key; a leaf at
    another address (equal values), or a palette of another shape, gives
    another."""
    _, scene, _ = served
    leaves = serving.scene_leaves(scene)
    vp, bones = view(0.0, 0.5)
    key = serving._call_key(leaves, vp, bones)
    assert serving._call_key(list(leaves), torch.as_tensor(vp),
                             bones.tolist()) == key
    moved = [leaves[0].clone()] + leaves[1:]
    assert serving._call_key(moved, vp, bones) != key
    assert serving._call_key(leaves, vp, bones[:1]) != key
