"""Port vs reference: the port's own copies of the host layer.

The port imports nothing of the JAX package, so it carries copies of the
host modules its scenes need (``fixtures``, ``formats``, ``dti``,
``resources``, ``scene``, ``app.camera``, ``render.vertex`` and
``render.cpu_reference``) and ports the device halves of the skeleton
and animation modules to torch. These tests hold the copies to the JAX
package's modules on the same inputs.

Tolerances:
- fixture bytes, DTI entries, demo and world batches, cameras: equal;
- the animation's device functions (``Skeleton.pose_device``,
  ``sample_device``, ``BoneAnimator.bone_mats``/``bone_mats_device``,
  ``MaterialAnimator.mat_color``, torch on the CPU) against JAX's
  within 1e-5 absolute (the port takes cos and sin in f64 and writes
  the 4x4 products as elementwise f32 ops in one fixed order; XLA rounds
  its own way);
- the port's host palette against its device palette: bit for bit.
"""

import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mt_renderer_tpu import fixtures as jfix
from mt_renderer_tpu.formats import sdl as jsdl
from mt_renderer_tpu.scene import animation as janim
from mt_renderer_tpu.scene import demo as jdemo
from mt_renderer_tpu.scene import world as jworld
from mt_renderer_tpu_torch import fixtures as tfix
from mt_renderer_tpu_torch.formats import sdl as tsdl
from mt_renderer_tpu_torch.scene import animation as tanim
from mt_renderer_tpu_torch.scene import demo as tdemo
from mt_renderer_tpu_torch.scene import world as tworld

SMALL = dict(buildings=18, characters=3, variants=6, terrain_subdiv=3)


def assert_batches_equal(got, want):
    """Every DrawBatch field, and ``mat_color_host`` where set, equal."""
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None:
            assert g is None, f.name
        elif isinstance(w, list):
            assert len(g) == len(w), f.name
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    for extra in ("mat_color_host",):
        assert hasattr(got, extra) == hasattr(want, extra), extra
        if hasattr(want, extra):
            np.testing.assert_array_equal(getattr(got, extra),
                                          getattr(want, extra))


@pytest.mark.parametrize("name,kw", [
    ("build_texture_rgba", dict(size=32)),
    ("build_shader2", {}),
    ("build_model", dict(skinned=True)),
    ("build_model", dict(skinned=False, subdiv=3)),
    ("build_model_rich", dict(subdiv=0)),
    ("build_model_rich", dict(subdiv=4)),
    ("build_model_skin8", {}),
    ("build_material", {}),
    ("build_scheduler_bones", dict(frames=48)),
])
def test_fixture_builders_give_the_same_bytes(name, kw):
    assert getattr(tfix, name)(**kw) == getattr(jfix, name)(**kw)


@pytest.mark.parametrize("kw", [
    dict(instances=1, skinned=True, subdiv=0),
    dict(instances=6, skinned=True, subdiv=2),
    dict(instances=4, skinned=False, subdiv=1),
], ids=["skinned-subdiv0", "skinned-subdiv2", "static-subdiv1"])
def test_demo_batch_matches_jax(kw):
    assert_batches_equal(tdemo.build_demo_batch(**kw),
                         jdemo.build_demo_batch(**kw))


def test_translucent_demo_batch_matches_jax():
    got = tdemo.make_translucent(tdemo.build_demo_batch(
        instances=8, skinned=True, subdiv=1), 8)
    want = jdemo.make_translucent(jdemo.build_demo_batch(
        instances=8, skinned=True, subdiv=1), 8)
    assert_batches_equal(got, want)
    np.testing.assert_array_equal(got.tri_material, want.tri_material)


@pytest.fixture(scope="module")
def worlds():
    return tworld.build_world(**SMALL), jworld.build_world(**SMALL)


def test_world_batch_matches_jax(worlds):
    got, want = worlds
    assert got.info == want.info
    assert got.info["materials"] == 1 + 18 + 3
    assert_batches_equal(got.batch, want.batch)
    for f in ("mat_color", "char_mats", "char_inv"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for f in ("joint_parents", "joint_offsets", "inverse_bind_mats"):
        np.testing.assert_array_equal(getattr(got.batch, f),
                                      getattr(want.batch, f))
    for f in ("parents", "local_mats", "inverse_bind_mats"):
        np.testing.assert_array_equal(getattr(got.skeleton, f),
                                      getattr(want.skeleton, f))
    assert got.timeline.duration == want.timeline.duration
    assert sorted(got.timeline.tracks) == sorted(want.timeline.tracks)


def test_cameras_match_jax():
    np.testing.assert_array_equal(
        tdemo.demo_camera(9, 320, 200).view_proj(),
        jdemo.demo_camera(9, 320, 200).view_proj())
    np.testing.assert_array_equal(
        tworld.world_camera(256, 144, buildings=130).view_proj(),
        jworld.world_camera(256, 144, buildings=130).view_proj())


def test_dti_entries_match_the_jax_registry():
    """The port carries a trimmed registry: each entry equals the JAX
    registry's, every parent chain is complete, and the scene path's
    lookups resolve."""
    treg = importlib.import_module("mt_renderer_tpu_torch.dti.registry")
    jreg = importlib.import_module("mt_renderer_tpu.dti.registry")
    entries = json.loads(treg._REGISTRY_PATH.read_text())
    full = {e["name"]: e for e in json.loads(
        jreg._REGISTRY_PATH.read_text())}
    assert 0 < len(entries) < 50
    for e in entries:
        assert e == full[e["name"]]
    tr, jr = treg.registry(), jreg.registry()

    def key(d):
        return (d.name, d.hash, d.size, d.file_ext, d.parent_name,
                tuple((p.name, p.type, p.attr) for p in d.props))

    for d in tr:
        assert key(d) == key(jr.from_hash(d.hash))
        assert d.parent_name is None or tr.from_name(d.parent_name)
    for name in ("rTexture", "nDraw::MaterialStd", "rModel", "rMaterial",
                 "rShader2", "rScheduler"):
        assert key(tr.from_name(name)) == key(jr.from_name(name))
    assert tr.from_name("rTexture").is_type_of(tr.from_name("cResource"))


# ------------------------------------------------------------ animation


def test_pose_device_matches_jax(worlds):
    rng = np.random.default_rng(0)
    sk_t, sk_j = worlds[0].skeleton, worlds[1].skeleton
    angles = rng.uniform(-1.0, 1.0, (6, sk_t.num_joints)).astype(np.float32)
    deltas = jnp.asarray(janim._euler_mats_jnp(*angles))
    got = sk_t.pose_device(torch.from_numpy(np.array(deltas)))
    want = np.asarray(sk_j.pose_device(deltas))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), sk_t.pose(np.array(deltas)),
                               atol=1e-5)


def _track(mode: int):
    tracks = [tsdl.Track(tsdl.TrackType.TYPE_FLOAT, 12, "joint1:rx", 0,
                         keys=[tsdl.Key(0, mode, 0.0), tsdl.Key(10, mode, 2.0),
                               tsdl.Key(25, mode, -1.0)])]
    t = tanim.Timeline(tsdl.SchedulerFile(tsdl.write_scheduler(tracks)))
    return tanim.track_arrays(t.tracks["joint1:rx"])


@pytest.mark.parametrize("mode", [0, 1], ids=["step", "linear"])
def test_sample_device_matches_jax(mode):
    f, v, lin = _track(mode)
    ft, vt, lt = (torch.from_numpy(a) for a in (f, v, lin))
    for t in (-3.0, 0.0, 4.5, 10.0, 17.25, 25.0, 40.0):
        got = float(tanim.sample_device(ft, vt, lt, t))
        want = float(janim.sample_device(jnp.asarray(f), jnp.asarray(v),
                                         jnp.asarray(lin), np.float32(t)))
        assert abs(got - want) <= 1e-5, (t, got, want)


def test_bone_mats_match_jax(worlds):
    ta, ja = worlds[0].animator(), worlds[1].animator()
    for frame in (0.0, 0.5, 12.0, 21.0, 30.0):
        host = ta.bone_mats(frame)
        dev = ta.bone_mats_device(frame, "cpu")
        assert isinstance(host, np.ndarray) and dev.device.type == "cpu"
        np.testing.assert_array_equal(host, dev.numpy())
        np.testing.assert_allclose(host, ja.bone_mats(frame), atol=1e-5)
        np.testing.assert_allclose(
            dev.numpy(), np.asarray(ja.bone_mats_device(np.float32(frame))),
            atol=1e-5)
    assert not np.allclose(ta.bone_mats(0.0), ta.bone_mats(30.0))


def test_bone_palette_on_a_tensor_matches_jax(worlds):
    """The world's per-character conjugation on a tensor stays a tensor
    and equals the NumPy path bit for bit and JAX's within 1e-5."""
    tw, jw = worlds
    base = tw.animator().bone_mats(12.0)
    got = tw.bone_palette(torch.from_numpy(base))
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == (24, 4, 4)
    np.testing.assert_array_equal(got.numpy(), tw.bone_palette(base))
    np.testing.assert_allclose(got.numpy(), jw.bone_palette(base),
                               atol=1e-5)


def test_mat_color_matches_jax():
    names = ["fixture_mat", "other"]

    def timeline(mod, sdl):
        tracks = [
            sdl.Track(sdl.TrackType.TYPE_FLOAT, 12, "material:other:a", 0,
                      keys=[sdl.Key(0, 1, 1.0), sdl.Key(30, 1, 0.0)]),
            sdl.Track(sdl.TrackType.TYPE_FLOAT, 12,
                      "material:fixture_mat:r", 0,
                      keys=[sdl.Key(0, 0, 0.5), sdl.Key(20, 0, 0.25)]),
        ]
        return mod.Timeline(sdl.SchedulerFile(sdl.write_scheduler(tracks)))

    ta = tanim.MaterialAnimator(timeline(tanim, tsdl), names)
    ja = janim.MaterialAnimator(timeline(janim, jsdl), names)
    for frame in (0.0, 7.5, 15.0, 29.0):
        got = ta.mat_color(frame, "cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(ja.mat_color(frame)),
                                   atol=1e-5)
    assert float(ta.mat_color(15.0, "cpu")[1, 3]) == pytest.approx(0.5)


# ---------------------------------------------------- viewer formats


@pytest.mark.parametrize("name,kw", [
    ("build_texture_bc1", {}),
    ("build_texture_bc7", dict(size=16)),
    ("build_shader_package", {}),
    ("build_character_prp", {}),
    ("build_character_prp", dict(parts_disp=(False, True, True),
                                 model_path="model\\fixture_cube_skinned")),
    ("build_gmd", {}),
    ("build_scheduler", {}),
    ("build_archive", {}),
])
def test_viewer_fixture_builders_give_the_same_bytes(name, kw):
    assert getattr(tfix, name)(**kw) == getattr(jfix, name)(**kw)


def _fmt(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.formats.{name}")


def test_xfs_parses_and_round_trips_like_jax():
    """The character ``.prp`` parses to the same object in both packages,
    and a serialized graph of every scalar and composite property type
    round-trips to the same values and bytes."""
    blob = tfix.build_character_prp(parts_disp=(True, False, True))
    objs = []
    for pkg in ("mt_renderer_tpu_torch", "mt_renderer_tpu"):
        xfs = _fmt(pkg, "xfs")
        root = xfs.deserialize(xfs.strip_prpz(blob))
        objs.append((root.class_type.name, root.class_type.hash,
                     repr(root.props)))
        specs = [xfs.ClassSpec("cResource", [
            xfs.PropSpec("mChild", xfs.PropType.classref),
            xfs.PropSpec("mName", xfs.PropType.string),
            xfs.PropSpec("mPos", xfs.PropType.vector3),
            xfs.PropSpec("mTimes", xfs.PropType.time),
            xfs.PropSpec("mQuat", xfs.PropType.quaternion),
            xfs.PropSpec("mDyn", xfs.PropType.custom,
                         attr=xfs.PROP_ATTR_DYNAMIC),
        ]), xfs.ClassSpec("MtObject", [
            xfs.PropSpec("mValue", xfs.PropType.s32),
            xfs.PropSpec("mFlags", xfs.PropType.u64),
        ])]
        graph = ("cResource", {
            "mChild": [("MtObject", {"mValue": [-7], "mFlags": [2**63]})],
            "mName": ["テスト"], "mPos": [(1.0, -0.5, 0.25)],
            "mTimes": [-1234567890123], "mQuat": [(0.0, 0.5, 0.5, 1.0)],
            "mDyn": [["rModel", "model\\fixture_cube"]],
        })
        data = xfs.serialize(graph, specs)
        back = xfs.deserialize(data)
        objs.append((data, repr(back.props)))
    assert objs[0] == objs[2] and objs[1] == objs[3]
    assert "mpModel" in objs[0][2]


def test_arc_parses_and_round_trips_like_jax(tmp_path):
    blob = tfix.build_archive()
    tables = []
    for pkg in ("mt_renderer_tpu_torch", "mt_renderer_tpu"):
        arc = _fmt(pkg, "arc")
        a = arc.ArchiveFile(blob)
        infos = a.resource_infos()
        tables.append([(i.path, i.dti.name, i.dti.hash, i.size_compressed,
                        i.size_uncompressed, i.quality, i.offset,
                        a.get_resource_by_info(i)) for i in infos])
        out = tmp_path / pkg
        (tmp_path / f"{pkg}.arc").write_bytes(blob)
        assert arc.unpack_archive(tmp_path / f"{pkg}.arc", out) == len(infos)
        arc.repack_archive(out, tmp_path / f"{pkg}_2.arc")
        again = arc.ArchiveFile((tmp_path / f"{pkg}_2.arc").read_bytes())
        assert [(i.path, i.dti.hash) for i in again.resource_infos()] == \
            [(i.path, i.dti.hash) for i in infos]
    assert tables[0] == tables[1] and len(tables[0]) == 8
    assert (tmp_path / "mt_renderer_tpu_torch_2.arc").read_bytes() == \
        (tmp_path / "mt_renderer_tpu_2.arc").read_bytes()


def test_spkg_parses_like_jax():
    blob = tfix.build_shader_package()
    got = []
    for pkg in ("mt_renderer_tpu_torch", "mt_renderer_tpu"):
        spkg, mfx = _fmt(pkg, "spkg"), _fmt(pkg, "mfx")
        p = spkg.ShaderPackageFile(blob, mfx.Shader2File(tfix.build_shader2()))
        got.append((
            [(s.code, s.crc) for s in p.vertex_shaders + p.pixel_shaders],
            [([None if o is None else o.name for o in i.layouts], i.crc)
             for i in p.inputs],
            p.shader_records.tobytes()))
    assert got[0] == got[1]
    assert got[0][0] == [(b"\xde\xad\xbe\xef", 0x1), (b"\xca\xfe", 0x2)]


def test_gmd_parses_and_round_trips_like_jax():
    out = []
    for pkg in ("mt_renderer_tpu_torch", "mt_renderer_tpu"):
        gmd = _fmt(pkg, "gmd")
        g = gmd.GuiMessageFile.parse(tfix.build_gmd())
        jp = gmd.GuiMessageFile(language_id=1, package_name="jp",
                                update_time=7, messages=[
                                    gmd.GuiMessage("A", "こんにちは"),
                                    gmd.GuiMessage("B", "line\r\ntwo")])
        back = gmd.GuiMessageFile.parse(jp.tobytes())
        out.append(([(m.label, m.message) for m in g.messages],
                    g.package_name, g.language_id, g.update_time,
                    g.tobytes(), jp.tobytes(),
                    [(m.label, m.message) for m in back.messages]))
    assert out[0] == out[1]
    assert out[0][4] == tfix.build_gmd()
    assert out[0][0][0] == ("LABEL_HELLO", "Hello, world!")


def test_viewer_dti_entries_match_jax():
    """The entries the viewers add (the character, the GUI message table,
    the shader package and the archive) resolve as in the JAX registry."""
    treg = importlib.import_module("mt_renderer_tpu_torch.dti.registry")
    jreg = importlib.import_module("mt_renderer_tpu.dti.registry")
    for name, ext in (("nGO::rCharacter", "chr"), ("rGUIMessage", "gmd"),
                      ("rShaderPackage", "spkg"), ("rArchive", "arc")):
        t, j = treg.from_name(name), jreg.from_name(name)
        assert (t.name, t.hash, t.size, t.file_ext, t.parent_name) == \
            (j.name, j.hash, j.size, j.file_ext, j.parent_name)
        assert t.file_ext == ext
        assert [(p.name, p.type, p.attr) for p in t.props] == \
            [(p.name, p.type, p.attr) for p in j.props]
        assert t.is_type_of(treg.from_name("cResource"))


def test_resource_manager_resolves_like_jax(tmp_path):
    """Loose files win, mounted archives are scanned, ``archive:path``
    mounts on the fly, a missing resource raises — as in the JAX
    package's ``ResourceManager``."""
    tfix.write_fixture_tree(tmp_path)
    lookups = [("model/fixture_cube", "rModel"),
               ("model\\fixture_cube_skinned", "rMaterial"),
               ("fixture_scene:chara\\fixture_character", "nGO::rCharacter"),
               ("fixture_scene:model\\fixture_albedo", "rTexture"),
               ("custom_shaders/CustomShaderPackage", "rShaderPackage")]
    got = []
    for pkg in ("mt_renderer_tpu_torch", "mt_renderer_tpu"):
        res = importlib.import_module(f"{pkg}.resources")
        dti = importlib.import_module(f"{pkg}.dti")
        rm = res.ResourceManager(tmp_path)
        out = [rm.get_resource_fancy(p, dti.from_name(d)).read()
               for p, d in lookups]
        rm.add_archive("fixture_scene")            # a second mount: no-op
        assert len(rm._archives) == 1
        (tmp_path / "model" / "fixture_cube.mod").rename(
            tmp_path / "model" / "moved.mod")
        out.append(rm.get_resource("model/fixture_cube",
                                   dti.from_name("rModel")).read())
        (tmp_path / "model" / "moved.mod").rename(
            tmp_path / "model" / "fixture_cube.mod")
        with pytest.raises(FileNotFoundError):
            rm.get_resource("model/nothing", dti.from_name("rModel"))
        got.append(out)
    assert got[0] == got[1]
    assert got[0][0] == got[0][-1] == tfix.build_model()
