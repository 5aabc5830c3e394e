"""Port vs reference: the two probe kernels and their tools.

- K3, the raster speed-of-light probe: ``raster.raster_micro_reference``
  (what ``raster_micro`` runs on a CPU tensor) against JAX
  ``tools/bench/raster_roofline.py::_micro`` in interpret mode, on the
  same chunk of the same setup. Tolerance: none; z, ids and the
  coefficient columns bit for bit (the same f32 plane arithmetic, the
  same tie rule; the port loads the winner's columns by id where the
  TPU kernel selects them one-hot, exactly).
- K4, the SWAR bilinear filter: ``device.bilin_swar_reference`` against
  JAX ``_swar_kernel`` through ``pl.pallas_call(interpret=True)`` with
  ``run_swar_pl``'s blocks. Integer arithmetic: bit for bit.
- The roofline's ``pair_counts`` against the JAX tool's on a small
  scene: the counts are integers, so equal.

The JAX tools are loaded from their files: ``raster_roofline.py`` has
no import-time work; ``bilin_ab.py`` runs its benchmark at import, so
its three kernel functions are taken out of its source with ``ast``.
The CUDA kernels are held against these plain versions on the card by
``test_torch_gpu.py``."""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.tools import bilin_ab, raster_roofline
from torch_threads import one_thread  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "tools" / "bench"


@pytest.fixture(scope="module")
def jax_roofline():
    spec = importlib.util.spec_from_file_location(
        "jax_raster_roofline", BENCH / "raster_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.INTERP        # JAX on the CPU: Pallas in interpret mode
    return mod


@pytest.fixture(scope="module")
def swar_kernel():
    """``_swar_kernel`` of ``tools/bench/bilin_ab.py`` with the two
    functions it calls, compiled from the file's source alone."""
    tree = ast.parse((BENCH / "bilin_ab.py").read_text())
    defs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_swar_lerp", "swar_math", "_swar_kernel")]
    assert len(defs) == 3
    ns = {"jnp": jnp, "jax": jax}
    exec(compile(ast.Module(body=defs, type_ignores=[]), "bilin_ab.py",
                 "exec"), ns)
    return ns["_swar_kernel"]


def _normals(batch):
    """Unit normals pointing away from the batch's centroid (the demo
    scene carries none, so its lambert factor is the 0.3 floor)."""
    c = batch.positions - batch.positions.mean(0)
    batch.normals = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(
        np.float32)
    return batch


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("lit", [False, True], ids=["n_coef18", "n_coef27"])
def test_micro_reference_matches_jax_micro(jax_roofline, lit):
    """128x16, so that chunk 0 of the 4-instance scene covers the tile;
    reps=2 and the unlit (18) or lit (27) coefficient columns."""
    w, h, reps = 128, 16, 2
    batch = _normals(demo.build_demo_batch(instances=4, skinned=True,
                                           subdiv=1))
    vp = np.asarray(demo.demo_camera(4, w, h).view_proj())
    bones = demo.demo_bone_mats(0.3)
    js = jd.upload(batch)
    clip = jd.vertex_stage(js, jnp.asarray(vp), jnp.asarray(bones))
    cols, _, n_attr = jd.setup_packed_cols(js, clip, w, h,
                                           bone_mats=jnp.asarray(bones),
                                           lighting=lit)
    n_coef = pr._N_COEF[n_attr]
    want = [np.asarray(x) for x in jax_roofline._micro(
        pr.pack_cols(cols)[0], reps, n_coef)]
    chunk = torch.from_numpy(np.ascontiguousarray(np.asarray(cols).T))
    got = [x.numpy() for x in tr.raster_micro(chunk[:, :tr.CT], reps,
                                              n_coef)]
    ids = want[1]
    assert (ids >= 0).mean() > 0.02
    for g, wv in zip(got, want):
        assert g.dtype == wv.dtype and g.shape == wv.shape
        np.testing.assert_array_equal(g, wv)
    # ties go to the later rep: every winner comes from the last one
    live = ids[ids >= 0]
    assert ((live >= (reps - 1) * tr.CT) & (live < reps * tr.CT)).all()


def test_micro_cpu_tensor_runs_the_plain_probe():
    chunk = torch.zeros((tr.N_RAST + tr.N_COEF, tr.CT))
    before = tr.raster_micro.launches
    z, ids, coef = tr.raster_micro(chunk, 3, tr.N_COEF)
    assert tr.raster_micro.launches == before == 0
    assert tuple(z.shape) == (1, 1, tr.P) and tuple(coef.shape) == (
        1, tr.N_COEF, tr.P)
    # zero planes: z = 0 everywhere, but no edge test passes (0 > 0)
    assert (ids == -1).all() and torch.isinf(z).all() and (coef == 0).all()
    with pytest.raises(ValueError, match="one row"):
        tr.raster_micro(chunk, 3, tr.N_COEF, rows=4)
    with pytest.raises(ValueError, match="chunk_cols"):
        tr.raster_micro(chunk[:20], 3, tr.N_COEF)


# ------------------------------------------------------------------ K4


def _swar_inputs(n: int, npool: int = 5461, seed: int = 0):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, (npool, 4), dtype=np.uint32)
    idx = rng.integers(-3, npool, n).astype(np.int32)
    fx = rng.random(n, dtype=np.float32)
    fy = rng.random(n, dtype=np.float32)
    # the weight's edges: 0, 1, the rounding boundaries at k/256 - 0.5/256
    fx[:8] = [0.0, 1.0, 0.5 / 256, 1.5 / 256, 255.5 / 256, 0.999999, 1e-9,
              0.25]
    fy[:4] = [1.0, 0.0, 127.5 / 256, 128.5 / 256]
    return pool, idx, fx, fy


def test_swar_reference_matches_jax_kernel(swar_kernel):
    """n = 131,072: two of ``run_swar_pl``'s 65,536-row blocks."""
    n, blk = 131_072, 65_536
    pool, idx, fx, fy = _swar_inputs(n)
    q32 = jnp.asarray(pool)[jnp.maximum(jnp.asarray(idx), 0)]
    want = pl.pallas_call(
        swar_kernel, grid=(n // blk,),
        in_specs=[pl.BlockSpec((blk, 4), lambda i: (i, 0)),
                  pl.BlockSpec((blk,), lambda i: (i,)),
                  pl.BlockSpec((blk,), lambda i: (i,))],
        out_specs=pl.BlockSpec((blk,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n,), jnp.uint32),
        interpret=True)(q32, jnp.asarray(fx), jnp.asarray(fy))
    got = td.bilin_swar(torch.from_numpy(pool.view(np.int32)),
                        torch.from_numpy(idx), torch.from_numpy(fx),
                        torch.from_numpy(fy))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_swar_weights_and_exact_texels():
    """Weight 0 returns texel 0, weight 256 on both axes texel 3, and a
    uniform quad filters to itself at any fraction."""
    rng = np.random.default_rng(1)
    pool = rng.integers(0, 2**32, (7, 4), dtype=np.uint32)
    pool[6] = pool[6, 0]                               # a uniform quad
    idx = np.array([0, 1, 2, 6, 6, 99], np.int32)      # 99 clamps to 6
    fx = np.array([0.0, 1.0, -3.0, 0.37, 0.81, 0.5], np.float32)
    fy = np.array([0.0, 1.0, 0.0, 0.62, 0.05, 0.5], np.float32)
    got = td.bilin_swar(torch.from_numpy(pool.view(np.int32)),
                        torch.from_numpy(idx), torch.from_numpy(fx),
                        torch.from_numpy(fy)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, [pool[0, 0], pool[1, 3], pool[2, 0],
                                        pool[6, 0], pool[6, 0], pool[6, 0]])


def test_swar_cpu_dispatch_and_arguments():
    pool, idx, fx, fy = (torch.from_numpy(a) for a in _swar_inputs(64, 9))
    pool = pool.view(torch.int32)
    before = td.bilin_swar.launches
    assert torch.equal(td.bilin_swar(pool, idx, fx, fy),
                       td.bilin_swar_reference(pool, idx, fx, fy))
    assert td.bilin_swar.launches == before == 0
    with pytest.raises(ValueError, match="pool_u32"):
        td.bilin_swar(pool.to(torch.int64), idx, fx, fy)
    with pytest.raises(ValueError, match="fy must be f32"):
        td.bilin_swar(pool, idx, fx, fy[:-1])


def test_bilin_forms_agree_on_the_probe_pool():
    """The tool's four forms on its own scene's pool at a small row
    count: the f32 forms within 1e-3 of each other, the 8-bit-weight SWAR
    forms within 1.5 of them per channel, the kernel's dispatch equal to
    the plain SWAR."""
    pool, pool_u32, idx, f = bilin_ab.probe_inputs("cpu", rows=4096, sets=1)
    args = (pool, pool_u32, idx[0], f[0, 0], f[1, 0])
    ein = bilin_ab.run_einsum(*args)
    planar = bilin_ab.run_planar(*args)
    torch.testing.assert_close(planar, ein, atol=1e-3, rtol=0)
    swar = bilin_ab.run_swar(*args)
    assert torch.equal(bilin_ab.run_swar_kernel(*args), swar)
    bits = swar.to(torch.int64) & 0xFFFFFFFF
    chans = torch.stack([((bits >> (8 * c)) & 0xFF).float()
                         for c in range(4)])
    assert float((chans - ein).abs().max()) <= 1.5


# ------------------------------------------------------------------ tools


def test_pair_counts_match_jax_tool(jax_roofline, monkeypatch):
    """The roofline's binned and winning pair counts on a small scene
    over three views, against the JAX tool's (both tools' frame size
    patched down to the test's)."""
    w, h = 256, 128
    for name, val in (("W", w), ("H", h), ("PW", w), ("PH", h)):
        monkeypatch.setattr(jax_roofline, name, val)
    monkeypatch.setattr(raster_roofline, "W", w)
    monkeypatch.setattr(raster_roofline, "H", h)
    batch = demo.build_demo_batch(instances=9, skinned=True, subdiv=1)
    bones = demo.demo_bone_mats(0.3)
    cam = demo.demo_camera(9, w, h)
    vps = []
    for i in range(3):
        cam.yaw = 15.0 + 3.0 * i
        vps.append(np.asarray(cam.view_proj()))
    maxc = td.auto_maxc(batch, vps[0], bones, width=w, height=h)
    want = jax_roofline.pair_counts(jd.upload(batch), vps, bones, maxc)
    got = raster_roofline.pair_counts(td.upload(batch, device="cpu"), vps,
                                      bones, maxc)
    assert got == tuple(want)
    assert 0 < got[1] <= got[0]


def test_roofline_presets():
    """The world preset is the reference tool's: 280 buildings of
    subdivisions (4, 6, 8, 10, 12), the characters posed at scheduler
    frame 0.5, the world camera's yaw stepping 3 degrees, K1 in mtap."""
    case, vps, bones, mode = raster_roofline.build("world", "cpu", views=2)
    assert isinstance(case, entry.WorldCase) and mode == "mtap"
    assert case.world.info["buildings"] == 280
    assert len(vps) == 2 and not np.array_equal(vps[0], vps[1])
    np.testing.assert_array_equal(bones, case.bone_mats(0.5))
    assert bones.shape == (case.batch.inverse_bind_mats.shape[0], 4, 4)
    with pytest.raises(ValueError, match="unknown preset"):
        raster_roofline.build("nope", "cpu")


def test_tools_refuse_to_run_without_a_card():
    """The timing tools never time the plain versions in the kernels'
    place: without a CUDA device they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for run in (lambda: raster_roofline.main(["default"]), bilin_ab.main,
                bilin_ab.timings):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    scene = td.upload(demo.build_demo_batch(instances=1, skinned=False),
                      device="cpu")
    vp = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        raster_roofline.rates(scene, vp, None)
