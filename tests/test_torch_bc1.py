"""Port vs reference: the bc1-resident texel pool and its host pieces.

``render/bcn.py`` (the BC1 half of the reference's), ``native.py`` (the
port's binding of ``csrc/bcn_native.cpp``), the bc1 pool build
(``_build_bc1_pool``), ``upload(pool_mode="bc1", bc1_chains=)``, the bc1
trilinear sampler (one 64 B row gather and eight BC1 texel decodes), the
frames it feeds through the plain K1 and K2 (single-layer mip, lit and
unlit; split and ml peeled mip), ``formats.tex``'s ``bc1_chain`` and
BCn decoding, and a JAX bc1 scene carried across.

Tolerance: none, every comparison bit for bit.
- Host code, the device decode (integer torch ops) and the pool build
  against the JAX package.
- The sampler against JAX's ``sample_trilinear`` on the same bc1 scene:
  the decoded footprints (integers) and their fractions exactly, and the
  sample exactly once JAX's contraction, an einsum whose four-corner sum
  runs in another order (up to 2 ulp apart), is replaced by the port's
  sequential sum run eagerly. The reference's own contract, the bc1
  sample equal to a quad pool of the BC1-decoded chains, holds in the
  port too (and against the narrow and tri pools of those chains).
- Frames: the bc1 frame equals the decoded-chains quad pool's frame.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu import native as jnative
from mt_renderer_tpu.fixtures import (build_texture_bc1, build_texture_bc7,
                                      build_texture_rgba, encode_bc1_simple)
from mt_renderer_tpu.formats import tex as jtex
from mt_renderer_tpu.render import bcn as jbcn
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch import entry
from mt_renderer_tpu_torch import native as tnative
from mt_renderer_tpu_torch.formats import tex as ttex
from mt_renderer_tpu_torch.render import bcn as tbcn
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import engine as te
from mt_renderer_tpu_torch.render import raster as tr
from test_torch_pools import assert_scene_equal
from test_torch_upload import SCENES
from torch_threads import one_thread  # noqa: F401

W, H = 128, 64
SIZES = [(37, 23), (1, 1), (5, 9), (3, 17), (64, 64)]


def seeded_blocks(n: int, seed: int = 0) -> np.ndarray:
    """(n, 8) random BC1 blocks: both color modes, index words with bit
    31 set, and three-color blocks whose index 3 is punch-through."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    blk[::3, 7] |= 0x80                      # bit 31 of the index word
    blk[1::4, 1] = blk[1::4, 3] & 0x7F       # c0 <= c1: three-color
    blk[2::5, 4:] = 0xFF                     # every texel index 3
    return blk


def alpha_batch(instances: int = 9, subdiv: int = 1):
    """The demo batch with punch-through texels (alpha 10) on 30% of its
    texture; opaque texels keep 255, so the opacity flag of the original
    and of the decoded texture agree."""
    batch = demo.build_demo_batch(instances=instances, skinned=True,
                                  subdiv=subdiv)
    rng = np.random.default_rng(3)
    texs = []
    for t in batch.textures:
        t = t.copy()
        t[..., 3] = np.where(rng.random(t.shape[:2]) < 0.3, 10,
                             255).astype(np.uint8)
        texs.append(t)
    return dc.replace(batch, textures=texs)


def decoded_chains(batch):
    """Each texture's box-filter chain, every level BC1-encoded and
    decoded: the content a bc1 pool holds."""
    return [[tbcn.decode_bc1_blocks_numpy(tbcn.encode_bc1_numpy(img),
                                          img.shape[1], img.shape[0])
             for img in td.mip_chain(t)] for t in batch.textures]


# ------------------------------------------------------------ bcn, native


@pytest.mark.parametrize("h,w", SIZES)
def test_bcn_numpy_copies_match_reference(h, w):
    nb = ((h + 3) // 4) * ((w + 3) // 4)
    blk = seeded_blocks(nb, seed=h * 100 + w)
    data = blk.tobytes()
    np.testing.assert_array_equal(tbcn.decode_bc1_numpy(data, w, h),
                                  jbcn.decode_bc1_numpy(data, w, h))
    np.testing.assert_array_equal(tbcn.decode_bc1_blocks_numpy(blk, w, h),
                                  jbcn.decode_bc1_blocks_numpy(blk, w, h))
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = np.where(rng.random((h, w)) < 0.3, 9, 255)
    np.testing.assert_array_equal(tbcn.encode_bc1_numpy(img),
                                  jbcn.encode_bc1_numpy(img))
    for b in blk[:8]:
        np.testing.assert_array_equal(
            tbcn.decode_bc1_block_scalar(b.tobytes()),
            jbcn.decode_bc1_block_scalar(b.tobytes()))
    c = np.arange(0, 1 << 16, 97, dtype=np.uint32)
    for a, b in zip(tbcn._rgb565_to_rgb888(c), jbcn._rgb565_to_rgb888(c)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("h,w", SIZES)
def test_decode_bc1_device_matches_reference(h, w):
    """The integer torch decode against the NumPy and the JAX device
    decoders, on blocks in both modes with index words past bit 31."""
    nb = ((h + 3) // 4) * ((w + 3) // 4)
    blk = seeded_blocks(nb, seed=h * 7 + w)
    if nb >= 8:
        assert (blk[:, 7] >= 0x80).any() and (blk[:, 4:] == 0xFF).all(1).any()
    got = tbcn.decode_bc1_device(torch.from_numpy(blk.reshape(-1)), w, h)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  jbcn.decode_bc1_numpy(blk.tobytes(), w, h))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbcn.decode_bc1_device(blk.reshape(-1), w,
                                                       h)))
    host = tbcn.decode_bc1_device(blk.tobytes(), w, h, device="cpu")
    assert torch.equal(host, got)
    with pytest.raises(ValueError, match="device"):
        tbcn.decode_bc1_device(blk.tobytes(), w, h)


def test_native_binding_matches_numpy_and_reference():
    """The port's own build of ``csrc/bcn_native.cpp`` (under
    ``build/native/``) encodes and decodes BC1 exactly as the NumPy
    path and the JAX package's binding do."""
    assert tnative.available()
    assert tnative._target().parent == tnative.BUILD_DIR
    rng = np.random.default_rng(5)
    for h, w in SIZES:
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        img[..., 3] = np.where(rng.random((h, w)) < 0.2, 3, 255)
        blk = tnative.encode_bc1(img)
        np.testing.assert_array_equal(blk, tbcn.encode_bc1_numpy(img))
        np.testing.assert_array_equal(blk, jnative.encode_bc1(img))
        data = seeded_blocks(blk.shape[0], seed=w).tobytes()
        np.testing.assert_array_equal(tnative.decode_bc1(data, w, h),
                                      tbcn.decode_bc1_numpy(data, w, h))
    with pytest.raises(ValueError, match="truncated"):
        tnative.decode_bc1(b"\0" * 8, 8, 8)


def test_native_decode_bc7_matches_reference():
    """Random blocks of all eight BC7 modes through the port's binding
    against the reference's NumPy decoder."""
    rng = np.random.default_rng(11)
    h, w = 21, 30
    nb = ((h + 3) // 4) * ((w + 3) // 4)
    blk = rng.integers(0, 256, (nb, 16), dtype=np.uint8)
    m = rng.integers(0, 8, nb)
    blk[:, 0] = ((1 << m) | ((blk[:, 0].astype(np.int64) << (m + 1))
                             & 0xFF)).astype(np.uint8)
    np.testing.assert_array_equal(
        tnative.decode_bc7(blk.tobytes(), w, h),
        jbcn.decode_bc7_numpy(blk.tobytes(), w, h))
    with pytest.raises(ValueError, match="truncated"):
        tnative.decode_bc7(blk.tobytes()[:16], w, h)


@pytest.mark.parametrize("build", [build_texture_bc1, build_texture_bc7,
                                   build_texture_rgba],
                         ids=["bc1", "bc7", "rgba8"])
def test_tex_decode_matches_reference(build):
    data = build(32)
    np.testing.assert_array_equal(ttex.TextureFile(data).decode_rgba8(),
                                  jtex.TextureFile(data).decode_rgba8())


# ------------------------------------------------------------ the pool


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bc1_upload_matches_jax_leaf_by_leaf(name):
    batch = SCENES[name]()
    ts = td.upload(batch, "bc1", device="cpu")
    assert ts.mip_pool.shape[-1] == 128
    assert_scene_equal(ts, jd.upload(batch, pool_mode="bc1"))


@pytest.mark.parametrize("chunk", [None, 64])
def test_build_bc1_pool_matches_jax(monkeypatch, chunk):
    """Seeded compact blocks over odd levels (a chain of 37x23 down to
    1x1 and a lone 5x9 level), built in one step and in many small ones
    (the last step's start clamped back, as the reference clamps it)."""
    segs, off = [], 0
    for h, w, nxt in [(37, 23, (18, 11)), (18, 11, (9, 5)), (9, 5, (4, 2)),
                      (4, 2, (2, 1)), (2, 1, (1, 1)), (1, 1, None),
                      (5, 9, None)]:
        bh, bw = (h + 3) // 4, (w + 3) // 4
        par = ((off + bh * bw, (nxt[0] + 3) // 4, (nxt[1] + 3) // 4)
               if nxt else (-1, 1, 1))
        segs.append((off, bh, bw, *par))
        off += bh * bw
    segs = np.asarray(segs, np.int32)
    cpool = seeded_blocks(off, seed=2)
    if chunk:
        monkeypatch.setattr(td, "_TRI_BUILD_CHUNK", chunk)
        monkeypatch.setattr(jd, "_TRI_BUILD_CHUNK", chunk)
    got = td._build_bc1_pool(torch.from_numpy(cpool), segs)
    want = np.asarray(jd._build_bc1_pool(jnp.asarray(cpool), segs))
    assert tuple(got.shape) == ((off + 1) // 2, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bc1_pool_stats_and_budget():
    """The reference's accounting: logical block rows (two per 128 B
    row), 64 B resident and 8 B uploaded per block, about 5.3 B per
    source texel; the budget charges the block rows once."""
    batch = demo.build_demo_batch(instances=4, skinned=False)
    scene = td.upload(batch, "bc1", device="cpu")
    st = td.pool_stats(scene)
    blocks = sum(max(64 >> i, 4) ** 2 // 16 for i in range(5)) + 1 + 1
    assert st["rows"] == blocks + (blocks % 2)
    assert st["bytes"] == st["rows"] * 64
    assert st["upload_bytes"] == st["rows"] * 8
    assert 5.0 < st["bytes_per_src_texel"] < 5.8
    assert td.upload(batch, "bc1", device="cpu",
                     pool_budget_bytes=blocks * 64).pool_mode == "bc1"
    with pytest.raises(MemoryError, match="charged once"):
        td.upload(batch, "bc1", device="cpu",
                  pool_budget_bytes=blocks * 64 - 1)


def test_bc1_pool_bias_matches_jax():
    batch = alpha_batch(instances=4, subdiv=0)
    assert_scene_equal(td.upload(batch, "bc1", device="cpu", pool_bias=2),
                       jd.upload(batch, pool_mode="bc1", pool_bias=2))


# --------------------------------------------------------- the sampler


def _odd_batch():
    """One 37x23 texture with punch-through texels: both block and
    extent parities, every clamp case."""
    batch = demo.build_demo_batch(instances=4, skinned=False)
    rng = np.random.default_rng(1)
    t = rng.integers(0, 256, (37, 23, 4)).astype(np.uint8)
    t[..., 3] = np.where(rng.random((37, 23)) < 0.25, 7, 255)
    return dc.replace(batch, textures=[t]), rng


def _sweep(rng, num_mips: int, n: int = 64):
    u = rng.uniform(-0.1, 1.1, (n, n)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, (n, n)).astype(np.float32)
    lod = rng.uniform(-1.0, num_mips + 1.0, (n, n)).astype(np.float32)
    return u, v, lod


def _port_sample(scene, u, v, lod):
    """The port's trilinear sampler at texture 0 → (n, n, 4) f32."""
    off0, th, tw = (torch.full(u.shape, int(x), dtype=torch.int32)
                    for x in scene.mip_table[0, 0])
    return torch.stack(td._trilinear_arith(
        scene.mip_pool, off0, th, tw, torch.from_numpy(lod),
        torch.from_numpy(u), torch.from_numpy(v), scene.num_mips,
        mode=scene.pool_mode), -1)


def test_bc1_sampler_dense_sweep_matches_jax(monkeypatch):
    """JAX's ``sample_trilinear`` and the port's sampler on the same bc1
    scene over a dense (u, v, lod) sweep, fractional and integer lods."""
    batch, rng = _odd_batch()
    js = jd.upload(batch, pool_mode="bc1")
    ts = td.upload(batch, "bc1", device="cpu")
    assert_scene_equal(ts, js)
    u, v, lod = _sweep(rng, ts.num_mips)
    seen = {"jax": [], "port": []}
    jcontract, tcontract = jd._contract_quad, td._contract_quad

    def jax_seq(quad, fx, fy, planes):
        seen["jax"].append((np.asarray(quad), np.asarray(fx),
                            np.asarray(fy)))
        wq = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
        return (wq[0][..., None] * quad[..., 0, :]
                + wq[1][..., None] * quad[..., 1, :]
                + wq[2][..., None] * quad[..., 2, :]
                + wq[3][..., None] * quad[..., 3, :])

    def port_rec(quad, fx, fy):
        seen["port"].append((quad.reshape(quad.shape[:-1] + (4, 4)).to(
            torch.float32).numpy(), fx.numpy(), fy.numpy()))
        return tcontract(quad, fx, fy)

    monkeypatch.setattr(jd, "_contract_quad", jax_seq)
    monkeypatch.setattr(td, "_contract_quad", port_rec)
    layer = jnp.zeros(u.shape, jnp.int32)
    for ld in (lod, np.floor(lod)):
        want = np.asarray(jd.sample_trilinear(js, layer, jnp.asarray(u),
                                              jnp.asarray(v),
                                              jnp.asarray(ld)))
        got = _port_sample(ts, u, v, ld).numpy()
        np.testing.assert_array_equal(got, want)
    assert len(seen["jax"]) == len(seen["port"]) == 4   # child, parent x2
    for (gq, gx, gy), (wq, wx, wy) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(gq, wq)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    # punch-through texels and deeper levels are in the sweep
    assert (seen["port"][0][0][..., 3] == 0).any()
    monkeypatch.setattr(jd, "_contract_quad", jcontract)
    with pytest.raises(AssertionError):     # the einsum sums otherwise
        np.testing.assert_array_equal(
            np.asarray(jd.sample_trilinear(js, layer, jnp.asarray(u),
                                           jnp.asarray(v),
                                           jnp.asarray(lod))),
            _port_sample(ts, u, v, lod).numpy())


@pytest.mark.parametrize("mode", ["quad", "narrow", "tri"])
def test_bc1_sampler_equals_decoded_chains(mode):
    """The reference's contract: the bc1 sample equals, bit for bit, the
    sample of a texel pool holding the BC1-decoded chains."""
    batch, rng = _odd_batch()
    bc1 = td.upload(batch, "bc1", device="cpu")
    ref = td.upload(batch, mode, device="cpu",
                    mip_chains=decoded_chains(batch))
    u, v, lod = _sweep(rng, bc1.num_mips)
    for ld in (lod, np.floor(lod)):
        assert torch.equal(_port_sample(bc1, u, v, ld),
                           _port_sample(ref, u, v, ld))


# ------------------------------------------------------------- frames


@pytest.fixture(scope="module")
def pair():
    """The punch-through demo scene as a bc1 pool and as a quad pool of
    its decoded chains, its view and bones."""
    batch = alpha_batch()
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    return dict(batch=batch, vp=vp, bones=demo.demo_bone_mats(0.4),
                bc1=td.upload(batch, "bc1", device="cpu"),
                quad=td.upload(batch, device="cpu",
                               mip_chains=decoded_chains(batch)))


@pytest.mark.parametrize("lighting", [False, True])
def test_bc1_mip_frame_equals_decoded_chains(pair, lighting):
    kw = dict(width=W, height=H, packed=True, mipmap=True,
              lighting=lighting, tap_tiles=td.auto_tap_tiles(
                  pair["batch"], pair["vp"], pair["bones"], width=W,
                  height=H))
    got, gd = td.render_frame(pair["bc1"], pair["vp"], pair["bones"], **kw)
    want, wd = td.render_frame(pair["quad"], pair["vp"], pair["bones"], **kw)
    tr.flush_overflow_checks()
    assert torch.equal(got, want) and torch.equal(gd, wd)
    assert 0.05 < float((wd < 1.0).float().mean()) < 0.95


@pytest.mark.parametrize("peel_mode", ["split", "ml"])
def test_bc1_peeled_mip_frame_equals_decoded_chains(pair, peel_mode):
    """Punch-through texels make the textured triangles translucent, so
    the split peel sends them through K2 (mtap) and the composite."""
    kw = dict(width=W, height=H, layers=3, peel_mode=peel_mode,
              packed=True, mipmap=True, lighting=True)
    caps = td.measure_live_tap_tiles(pair["bc1"], pair["vp"], pair["bones"],
                                     width=W, height=H, layers=3,
                                     lighting=True, mode=peel_mode)
    got, gd = td.render_frame_peeled(pair["bc1"], pair["vp"], pair["bones"],
                                     tap_tiles=caps, **kw)
    want, wd = td.render_frame_peeled(pair["quad"], pair["vp"],
                                      pair["bones"], tap_tiles=caps, **kw)
    tr.flush_overflow_checks()
    assert torch.equal(got, want) and torch.equal(gd, wd)
    assert float(pair["bc1"].cols_const[9].min()) == 0.0   # translucent


def test_bc1_tap_paths_raise(pair):
    for fn, kw in ((td.render_frame, {}),
                   (td.render_frame_peeled, dict(layers=2,
                                                 peel_mode="split")),
                   (td.render_frame_peeled, dict(layers=2))):
        with pytest.raises(ValueError, match="mipmap"):
            fn(pair["bc1"], pair["vp"], pair["bones"], width=W, height=H,
               **kw)


def test_bc1_world_frame_equals_decoded_chains():
    """A small archive world (mixed texture sizes in one pool) from
    ``entry.world_case(pool_mode="bc1")``: its frame equals the quad pool
    of its decoded chains, and ``FrameEngine`` renders it from a palette
    on the device as ``render_frame`` does at the engine's caps."""
    case = entry.world_case("cpu", buildings=8, width=W, height=96,
                            characters=2, variants=3, terrain_subdiv=2,
                            building_subdivs=(1,), pool_mode="bc1")
    quad = td.upload(case.batch, device="cpu",
                     mip_chains=decoded_chains(case.batch))
    vp, pal = case.view_proj(), case.bone_mats(6.0)
    kw = dict(width=W, height=96, packed=True, mipmap=True)
    got, _ = td.render_frame(case.scene, vp, pal, **kw)
    want, depth = td.render_frame(quad, vp, pal, **kw)
    assert case.scene.pool_mode == "bc1" and len(case.batch.textures) > 2
    assert torch.equal(got, want) and bool((depth < 1.0).any())
    # FrameEngine with the palette computed on the device (its guard
    # counts there too)
    pal_dev = case.bone_mats_device(6.0)
    assert isinstance(pal_dev, torch.Tensor)
    eng = te.FrameEngine(case.scene, case.batch, width=W, height=96,
                         mipmap=True)
    for t in range(2):
        case.camera.yaw += 2.0 * t
        vp = case.view_proj()
        got, _ = eng.render(vp, pal_dev)
        want, _ = td.render_frame(case.scene, vp, pal_dev, maxc=eng.maxc,
                                  tap_tiles=eng.tap_tiles, **kw)
        assert torch.equal(got, want)
    eng.check()
    tr.flush_overflow_checks()


# ------------------------------------------------------ assets, carrying


def test_bc1_asset_passthrough_matches_jax():
    """A BC1 ``.tex`` asset's own, partial mip chain (levels from another
    encoder, not box-filter related) uploads verbatim: the pool's anchor
    bytes are the asset's blocks, the scene equals the JAX package's upload
    of the same chain, and sampling equals a quad pool of the asset's
    decoded levels."""
    rng = np.random.default_rng(7)
    levels = []
    for lv in range(4):                      # 32..4: a partial chain
        s = 32 >> lv
        img = rng.integers(0, 256, (s, s, 4)).astype(np.uint8)
        img[..., 3] = 255
        levels.append(encode_bc1_simple(img))
    blob = ttex.write_texture(32, 32, int(ttex.TextureFormat.BC1), levels,
                              levels=len(levels))
    chain = ttex.TextureFile(blob).bc1_chain()
    jchain = jtex.TextureFile(blob).bc1_chain()
    assert len(chain) == 4
    for (a, ah, aw), (b, bh, bw) in zip(chain, jchain):
        np.testing.assert_array_equal(a, b)
        assert (ah, aw) == (bh, bw)
    batch = demo.build_demo_batch(instances=4, skinned=False)
    bc1 = td.upload(batch, "bc1", device="cpu", bc1_chains=[chain])
    assert bc1.num_mips == 4
    assert_scene_equal(bc1, jd.upload(batch, pool_mode="bc1",
                                      bc1_chains=[jchain]))
    pool = bc1.mip_pool.numpy().reshape(-1, 64)
    for lv, (blocks, _h, _w) in enumerate(chain):
        np.testing.assert_array_equal(pool[bc1.mip_table[0, lv, 0], :8],
                                      blocks[0])
    dec = [tnative.decode_bc1(np.ascontiguousarray(b).tobytes(), w, h)
           for b, h, w in chain]
    quad = td.upload(batch, device="cpu", mip_chains=[dec])
    u, v, lod = _sweep(rng, 4, n=48)
    assert torch.equal(_port_sample(bc1, u, v, lod),
                       _port_sample(quad, u, v, lod))
    with pytest.raises(ValueError, match="BC1"):
        ttex.TextureFile(build_texture_bc7(8)).bc1_chain()
    with pytest.raises(ValueError, match="pool_mode='bc1'"):
        td.upload(batch, "quad", device="cpu", bc1_chains=[chain])
    with pytest.raises(ValueError, match="not both"):
        td.upload(batch, "bc1", device="cpu", bc1_chains=[chain],
                  mip_chains=[dec])


def test_carried_jax_bc1_scene_renders_the_ports_frame(pair):
    """A JAX bc1 scene (its (1, 128) zero hint row included) carried
    across by ``scene_from_numpy`` renders the port's own bc1 frame; a
    JAX bc7 scene of the same batch carries across too, equal to the
    port's bc7 upload."""
    js = jd.upload(pair["batch"], pool_mode="bc1")
    leaves = {f: np.asarray(getattr(js, f)) for f in td.TENSOR_FIELDS}
    statics = {f: getattr(js, f) for f in td.STATIC_FIELDS}
    carried = td.scene_from_numpy(leaves, statics, "cpu")
    kw = dict(width=W, height=H, packed=True, mipmap=True)
    got, _ = td.render_frame(carried, pair["vp"], pair["bones"], **kw)
    want, _ = td.render_frame(pair["bc1"], pair["vp"], pair["bones"], **kw)
    tr.flush_overflow_checks()
    assert carried.pool_mode == "bc1" and torch.equal(got, want)
    js7 = jd.upload(pair["batch"], pool_mode="bc7")
    carried = td.scene_from_numpy(
        {f: np.asarray(getattr(js7, f)) for f in td.TENSOR_FIELDS},
        {f: getattr(js7, f) for f in td.STATIC_FIELDS}, "cpu")
    assert carried.pool_mode == "bc7" and carried.bc7_modes == (6,)
    assert_scene_equal(carried, js7)


def test_frame_profile_runs_the_bc1_world(capsys):
    """``frame_profile --world --mipmap --pool bc1`` rehearses on CPU
    tensors at a small size."""
    from mt_renderer_tpu_torch import frame_profile

    assert frame_profile.main(
        ["--device", "cpu", "--world", "--buildings", "4", "--mipmap",
         "--pool", "bc1", "--width", "128", "--height", "64", "--views",
         "1", "--frames", "1", "--prof-frames", "1"]) == 0
    out = capsys.readouterr().out
    assert "pool bc1" in out and "shade_mip_tap_flat_channels" in out
