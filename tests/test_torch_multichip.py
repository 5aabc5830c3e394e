"""Port: the band split and the geometry split (``parallel.tiles``).

The counterpart of ``tests/test_multichip.py``, on CPU slots
(``make_row_mesh(n, device="cpu")``, the n parts rendered one after
another): every split frame equals the port's single-device frame bit
for bit, color and depth, for n in {1, 2, 3, 4} at 64x64 and 128x96 (and
unaligned heights): packed, unpacked, mipmapped (tri, bc1 and bc7
pools), lit, the split peel and ``setup_shard``. A few cases also hold
the port's split frame to JAX's ``render_frame_multichip`` /
``render_frame_geomsplit`` on the conftest's 8-device CPU mesh (Pallas
in interpret mode) under the rule of ``test_torch_frame.py``: coverage
exact, color under the golden rule (at most 0.3% of pixels with a
channel off by more than 1), depth within 4e-6 (the reference's own
tolerance between its split and single frames,
``tests/test_multichip.py:179-183``). The band sizing helpers equal
JAX's, and the band grid's prediction equals K1's binning.
"""

import numpy as np
import pytest
import torch

from mt_renderer_tpu.parallel import tiles as jtiles
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.render import pallas_raster as pr
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch.parallel import tiles
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr

NS = [1, 2, 3, 4]
GOLDEN_SHARE = 0.003


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor ops, which
    slow down by an order of magnitude when the parallel test workers'
    threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(n):
    return tiles.make_row_mesh(n, device="cpu")


def assert_same(got, want):
    """A split frame bit for bit against its single-device frame."""
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def golden_share(got_u8, want_u8) -> float:
    diff = np.abs(got_u8.astype(np.int32) - want_u8.astype(np.int32))
    return float((diff.max(-1) > 1).mean())


def assert_near_jax(got, want):
    """The port's packed frame against JAX's: coverage exact, the golden
    rule on color, depth within 4e-6."""
    color, depth = got
    jcolor, jdepth = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(depth.numpy() < 1.0, jdepth < 1.0)
    np.testing.assert_allclose(depth.numpy(), jdepth, atol=4e-6)
    assert golden_share(td.unpack_rgba(color),
                        jd.unpack_rgba(jcolor)) <= GOLDEN_SHARE
    assert 0.0 < float((jdepth < 1.0).mean()) < 1.0


@pytest.fixture(scope="module")
def case():
    """``tests/test_multichip.py``'s scene: 4 skinned instances at the
    64x64 demo camera, bones at phase 0.7."""
    batch = demo.build_demo_batch(instances=4, skinned=True)
    vp = np.asarray(demo.demo_camera(4, 64, 64).view_proj())
    bones = demo.demo_bone_mats(0.7)
    return dict(batch=batch, vp=vp, bones=bones,
                ts=td.upload(batch, device="cpu"))


@pytest.fixture(scope="module")
def big():
    """96 instances at subdiv 1 (1,152 triangles): two setup shards of
    768, the second clamped to [384, 1152) with its first 384 rows
    masked."""
    batch = demo.build_demo_batch(instances=96, skinned=True, subdiv=1)
    vp = np.asarray(demo.demo_camera(96, 64, 60).view_proj())
    return dict(batch=batch, vp=vp, bones=demo.demo_bone_mats(0.3),
                ts=td.upload(batch, device="cpu"))


@pytest.fixture(scope="module")
def glass():
    batch = demo.make_translucent(
        demo.build_demo_batch(instances=4, skinned=True), 4, fraction=0.5)
    vp = np.asarray(demo.demo_camera(4, 64, 64).view_proj())
    return dict(batch=batch, vp=vp, bones=demo.demo_bone_mats(0.7),
                ts=td.upload(batch, device="cpu"))


# ------------------------------------------------------------ the mesh


def test_row_mesh_slots_and_cards():
    assert tiles.make_row_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(RuntimeError, match=r"needs 2, 0 visible"):
        tiles.make_row_mesh(2)
    with pytest.raises(ValueError):
        tiles.make_row_mesh(0, device="cpu")


# ------------------------------------------------------------ band split


class TestMultichip:
    @pytest.mark.parametrize("n", NS)
    @pytest.mark.parametrize("packed", [True, False])
    def test_sharded_matches_single(self, case, n, packed):
        kw = dict(width=64, height=64, packed=packed)
        want = td.render_frame(case["ts"], case["vp"], case["bones"], **kw)
        got = tiles.render_frame_multichip(case["ts"], case["vp"],
                                           case["bones"], mesh=mesh(n), **kw)
        assert_same(got, want)
        assert (got[1] < 1.0).any()

    @pytest.mark.parametrize("n", NS)
    def test_unaligned_height(self, case, n):
        """60 rows over n bands: ceil bands padded to whole tiles and
        cropped, equal to the single frame."""
        kw = dict(width=64, height=60, packed=True)
        want = td.render_frame(case["ts"], case["vp"], case["bones"], **kw)
        assert_same(tiles.render_frame_multichip(
            case["ts"], case["vp"], case["bones"], mesh=mesh(n), **kw), want)

    def test_packed_matches_unpacked(self, case):
        kw = dict(mesh=mesh(4), width=64, height=64)
        pc, pd = tiles.render_frame_multichip(case["ts"], case["vp"],
                                              case["bones"], packed=True, **kw)
        uc, ud = tiles.render_frame_multichip(case["ts"], case["vp"],
                                              case["bones"], **kw)
        assert pc.dtype == torch.int32 and uc.dtype == torch.uint8
        np.testing.assert_array_equal(td.unpack_rgba(pc), uc.numpy())
        assert torch.equal(pd, ud)

    @pytest.mark.parametrize("n", [2, 3])
    @pytest.mark.parametrize("flags", [dict(), dict(mipmap=True),
                                       dict(lighting=True)])
    def test_setup_shard_matches_replicated(self, big, n, flags):
        """Each slot's setup over its triangle range, the columns
        gathered once: the same frame as the replicated setup (the last
        shard's range is clamped and its aliased rows masked)."""
        kw = dict(mesh=mesh(n), width=64, height=60, packed=True, **flags)
        want = tiles.render_frame_multichip(big["ts"], big["vp"],
                                            big["bones"], **kw)
        got = tiles.render_frame_multichip(big["ts"], big["vp"],
                                           big["bones"], setup_shard=True,
                                           **kw)
        assert_same(got, want)
        assert (got[1] < 1.0).any()

    def test_scene_tri_shard_slices_corner_blocks(self, big):
        """A shard of the corner-planar scene is a scene of ``size``
        triangles: the three corner blocks, the triangle axis of the
        column-major constants; a range past the end is clamped and its
        aliased rows leave ``tri_vis``."""
        ts = big["ts"]
        tp = ts.tri_valid.shape[0]
        assert tp == 1152
        sh = tiles._scene_tri_shard(ts, 384, 384, tp)
        for c in range(3):
            assert torch.equal(sh.positions[c * 384:(c + 1) * 384],
                               ts.positions[c * tp + 384:c * tp + 768])
            assert torch.equal(sh.weights[c * 384:(c + 1) * 384],
                               ts.weights[c * tp + 384:c * tp + 768])
        assert torch.equal(sh.cols_const, ts.cols_const[:, 384:768])
        assert torch.equal(sh.tri_texture, ts.tri_texture[384:768])
        last = tiles._scene_tri_shard(ts, 768, 768, tp)
        assert torch.equal(last.cols_const, ts.cols_const[:, 384:])
        assert not bool(last.tri_vis[:384].any())
        assert torch.equal(last.tri_vis[384:], ts.tri_vis[768:])

    def test_validation(self, case, glass):
        kw = dict(mesh=mesh(2), width=64, height=64)
        with pytest.raises(ValueError, match="setup_shard"):
            tiles.render_frame_multichip(glass["ts"], glass["vp"],
                                         glass["bones"], peel_layers=2,
                                         setup_shard=True, **kw)
        with pytest.raises(NotImplementedError, match="by decision"):
            tiles.render_frame_multichip(case["ts"], case["vp"],
                                         case["bones"], backend="scan", **kw)
        with pytest.raises(ValueError, match="mesh or a process group"):
            tiles.render_frame_multichip(case["ts"], case["vp"],
                                         case["bones"], width=64, height=64)
        with pytest.raises(ValueError, match="cap pair"):
            tiles.render_frame_multichip(case["ts"], case["vp"],
                                         case["bones"], packed=True,
                                         tap_tiles=(8, 8), **kw)
        # the trilinear band takes a scalar cap only: a pair renders dense
        want = tiles.render_frame_multichip(case["ts"], case["vp"],
                                            case["bones"], mipmap=True, **kw)
        assert_same(tiles.render_frame_multichip(
            case["ts"], case["vp"], case["bones"], mipmap=True,
            tap_tiles=(1, 1), **kw), want)

    def test_matches_jax_bands(self, case):
        """The port's 4-band frame against JAX's band split over the
        8-device CPU mesh, both packed."""
        kw = dict(width=64, height=60, packed=True)
        got = tiles.render_frame_multichip(case["ts"], case["vp"],
                                           case["bones"], mesh=mesh(4), **kw)
        want = jtiles.render_frame_multichip(
            jd.upload(case["batch"]), case["vp"], case["bones"],
            mesh=jtiles.make_row_mesh(8), backend="pallas", **kw)
        tr.flush_overflow_checks()
        pr.flush_overflow_checks()
        assert_near_jax(got, want)


class TestMultichipQualityFlags:
    def test_lighting_matches_single_device(self):
        """The fixture's rich model (normals, several materials), lit and
        mipmapped, over 8 bands."""
        from mt_renderer_tpu_torch import fixtures
        from mt_renderer_tpu_torch.formats.mfx import Shader2File
        from mt_renderer_tpu_torch.formats.mod import ModelFile
        from mt_renderer_tpu_torch.scene.model import build_draw_batch

        batch = build_draw_batch(ModelFile(fixtures.build_model_rich()),
                                 None, Shader2File(fixtures.build_shader2()),
                                 None)
        ts = td.upload(batch, device="cpu")
        vp = np.asarray(demo.demo_camera(1, 64, 64).view_proj())
        kw = dict(width=64, height=64, lighting=True, mipmap=True)
        want = td.render_frame(ts, vp, None, **kw)
        assert_same(tiles.render_frame_multichip(ts, vp, None, mesh=mesh(8),
                                                 **kw), want)
        assert (want[1] < 1.0).any()


class TestMultichipTapCompaction:
    def test_compacted_matches_dense(self, case):
        tt = td.auto_tap_tiles(case["batch"], case["vp"], case["bones"],
                               width=64, height=64, bands=4)
        assert tt == jd.auto_tap_tiles(case["batch"], case["vp"],
                                       case["bones"], width=64, height=64,
                                       bands=4)
        kw = dict(mesh=mesh(4), width=64, height=64, packed=True)
        dense = tiles.render_frame_multichip(case["ts"], case["vp"],
                                             case["bones"], **kw)
        compact = tiles.render_frame_multichip(case["ts"], case["vp"],
                                               case["bones"], tap_tiles=tt,
                                               **kw)
        assert_same(compact, dense)

    def test_band_grid_prediction_matches_kernel(self):
        """``predict_bin_counts(y0=, grid_rows=)`` equals K1's binning of
        every band (``raster.bin_chunks``' true counts) and JAX's
        prediction; the band cap bounds every band's live tiles."""
        batch = demo.build_demo_batch(instances=9, skinned=False)
        ts = td.upload(batch, device="cpu")
        vp = np.asarray(demo.demo_camera(9, 128, 96).view_proj())
        n = 3
        tt = td.auto_tap_tiles(batch, vp, None, width=128, height=96,
                               bands=n, margin=1.0)
        assert tt == jd.auto_tap_tiles(batch, vp, None, width=128,
                                       height=96, bands=n, margin=1.0)
        _, d = tiles.render_frame_multichip(ts, vp, None, mesh=mesh(n),
                                            width=128, height=96,
                                            packed=True, tap_tiles=tt)
        cov = d.numpy() < 1.0
        band_h, pb = td.band_rows(96, n)
        cols, bbox = td.setup_packed_cols(ts, td.vertex_stage(ts, vp, None),
                                          128, 96)
        worst = 0
        for i in range(n):
            y0 = i * band_h
            pred = td.predict_bin_counts(batch, vp, None, width=128,
                                         height=96, y0=y0, grid_rows=pb)
            np.testing.assert_array_equal(pred, jd.predict_bin_counts(
                batch, vp, None, width=128, height=96, y0=y0,
                grid_rows=pb))
            *_, true = tr.bin_chunks(bbox, pb // tr.TILE_H, 1,
                                     cols.shape[1] // tr.CT, 0, y0)
            np.testing.assert_array_equal(pred.reshape(-1), true.numpy())
            assert td.predict_live_rows(
                batch, vp, None, width=128, height=96, y0=y0,
                grid_rows=pb) == jd.predict_live_rows(
                batch, vp, None, width=128, height=96, y0=y0, grid_rows=pb)
            band = np.zeros((pb, 128), bool)
            rows = cov[y0:y0 + band_h]
            band[:rows.shape[0]] = rows
            worst = max(worst, int(band.reshape(-1, tr.TILE_H, 1, 128)
                                   .any(axis=(1, 3)).sum()))
        assert tt >= worst
        tr.flush_overflow_checks()
        assert not tr.OVERFLOW_EVENTS


class TestMultichipPeel:
    @pytest.mark.parametrize("n", NS)
    def test_peeled_bands_match_single(self, glass, n):
        kw = dict(width=64, height=64)
        want = td.render_frame_peeled(glass["ts"], glass["vp"],
                                      glass["bones"], layers=3,
                                      peel_mode="split", **kw)
        got = tiles.render_frame_multichip(glass["ts"], glass["vp"],
                                           glass["bones"], mesh=mesh(n),
                                           peel_layers=3, **kw)
        assert_same(got, want)

    def test_packed_and_unaligned_height(self, glass):
        """52 rows over 8 bands: 7-row bands padded to 16-row tiles."""
        want, _ = td.render_frame_peeled(glass["ts"], glass["vp"],
                                         glass["bones"], width=64, height=52,
                                         layers=3, peel_mode="split")
        got, _ = tiles.render_frame_multichip(
            glass["ts"], glass["vp"], glass["bones"], mesh=mesh(8),
            width=64, height=52, peel_layers=3, packed=True)
        np.testing.assert_array_equal(td.unpack_rgba(got), want.numpy())

    @pytest.mark.parametrize("n", [2, 4])
    def test_banded_caps_match_dense(self, glass, n):
        """``measure_live_tap_tiles(mode="split", bands=n)`` is in one
        band's rows, and the capped banded peel equals the dense one."""
        kw = dict(width=64, height=64, layers=3, mode="split", bands=n)
        caps = td.measure_live_tap_tiles(glass["ts"], glass["vp"],
                                         glass["bones"], **kw)
        _, pb = td.band_rows(64, n)
        nrows_band = pb // tr.TILE_H
        assert 0 < caps[0] <= nrows_band and 0 < caps[1] <= 3 * nrows_band
        skw = dict(mesh=mesh(n), width=64, height=64, peel_layers=3)
        dense = tiles.render_frame_multichip(glass["ts"], glass["vp"],
                                             glass["bones"], **skw)
        got = tiles.render_frame_multichip(glass["ts"], glass["vp"],
                                           glass["bones"], tap_tiles=caps,
                                           **skw)
        assert_same(got, dense)
        tr.flush_overflow_checks()
        assert not tr.OVERFLOW_EVENTS

    def test_bands_requires_split_mode(self, glass):
        with pytest.raises(ValueError, match="bands"):
            td.measure_live_tap_tiles(glass["ts"], glass["vp"],
                                      glass["bones"], width=64, height=64,
                                      layers=3, mode="ml", bands=2)

    def test_mipmap_peeled_bands_match_single(self, glass):
        kw = dict(width=64, height=64, mipmap=True, lighting=True)
        want = td.render_frame_peeled(glass["ts"], glass["vp"],
                                      glass["bones"], layers=3,
                                      peel_mode="split", **kw)
        got = tiles.render_frame_multichip(glass["ts"], glass["vp"],
                                           glass["bones"], mesh=mesh(4),
                                           peel_layers=3, **kw)
        assert_same(got, want)


class TestMultichipMipmapExact:
    def test_banded_mip_caps_match_dense(self, case):
        caps = td.auto_tap_tiles(case["batch"], case["vp"], case["bones"],
                                 width=64, height=64, bands=4)
        kw = dict(mesh=mesh(4), width=64, height=64, mipmap=True,
                  lighting=True)
        dense = tiles.render_frame_multichip(case["ts"], case["vp"],
                                             case["bones"], **kw)
        got = tiles.render_frame_multichip(case["ts"], case["vp"],
                                           case["bones"], tap_tiles=caps,
                                           **kw)
        assert_same(got, dense)

    @pytest.mark.parametrize("n", NS)
    def test_pallas_mipmap_bands_bit_identical(self, case, n):
        kw = dict(width=64, height=64, mipmap=True, lighting=True)
        want = td.render_frame(case["ts"], case["vp"], case["bones"], **kw)
        assert_same(tiles.render_frame_multichip(
            case["ts"], case["vp"], case["bones"], mesh=mesh(n), **kw), want)

    @pytest.mark.parametrize("pool", ["tri", "bc1", "bc7"])
    def test_pallas_mipmap_bands_pools(self, case, pool):
        """The tri, bc1 and bc7 pools (block rows, the bc7 hint pool)
        banded over 3 and 8 slots, each equal to the single frame."""
        scene = td.upload(case["batch"], pool, mipmap=True, device="cpu")
        kw = dict(width=64, height=64, mipmap=True, lighting=True,
                  packed=True)
        want = td.render_frame(scene, case["vp"], case["bones"], **kw)
        for n in (3, 8):
            assert_same(tiles.render_frame_multichip(
                scene, case["vp"], case["bones"], mesh=mesh(n), **kw), want)


# ------------------------------------------------------- geometry split


class TestGeometrySplit:
    @pytest.mark.parametrize("n", NS)
    @pytest.mark.parametrize("flags", [dict(packed=True), dict(),
                                       dict(mipmap=True, lighting=True)])
    def test_matches_single_device(self, case, n, flags):
        kw = dict(width=64, height=64, **flags)
        want = td.render_frame(case["ts"], case["vp"], case["bones"], **kw)
        got = tiles.render_frame_geomsplit(case["ts"], case["vp"],
                                           case["bones"], mesh=mesh(n), **kw)
        assert_same(got, want)
        assert (got[1] < 1.0).any()

    def test_matches_jax_geomsplit(self, case):
        kw = dict(width=64, height=64, packed=True)
        got = tiles.render_frame_geomsplit(case["ts"], case["vp"],
                                           case["bones"], mesh=mesh(4), **kw)
        want = jtiles.render_frame_geomsplit(
            jd.upload(case["batch"]), case["vp"], case["bones"],
            mesh=jtiles.make_row_mesh(4), **kw)
        tr.flush_overflow_checks()
        pr.flush_overflow_checks()
        assert_near_jax(got, want)

    def test_cdiv_mult(self):
        assert tiles.cdiv_mult(1152, 4, 384) == jtiles.cdiv_mult(1152, 4, 384)
        assert tiles.cdiv_mult(1152, 4, 384) == 384
        assert tiles.cdiv_mult(768, 3, 384) == 384


class TestGeomsplitTapCompaction:
    def test_compacted_matches_dense(self, case):
        tt = td.auto_tap_tiles(case["batch"], case["vp"], case["bones"],
                               width=64, height=64)
        kw = dict(mesh=mesh(4), width=64, height=64, packed=True)
        dense = tiles.render_frame_geomsplit(case["ts"], case["vp"],
                                             case["bones"], **kw)
        compact = tiles.render_frame_geomsplit(case["ts"], case["vp"],
                                               case["bones"], tap_tiles=tt,
                                               **kw)
        assert_same(compact, dense)
        tr.flush_overflow_checks()
        assert not tr.OVERFLOW_EVENTS
