"""Compressed texture assets: the reference's BC1 and BC7 decoders
(``reference_bcn.py``) against the port's and an independent decoder's,
the seeded chains (``scenes/bcn.py``), a small compressed world added as
new files only and run whole on the CPU, the block faults, and the
reference of the scenes without chains unchanged."""

import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch import native
from portbench import bench, faults, reference, reference_bcn, views
from portbench.scenes import bcn, builder

from .small import small

N = 4096


def _bc7(mode: int) -> np.ndarray:
    rng = np.random.default_rng([2**31 + 41, mode])
    return bcn.bc7_blocks(rng, N, (mode,), opaque=False)


def _bc1() -> np.ndarray:
    return np.random.default_rng(2**31 + 43).integers(0, 256, (N, 8),
                                                      dtype=np.uint8)


@pytest.mark.parametrize("mode", range(8))
def test_bc7_decoder_equals_the_ports(mode):
    """4,096 random blocks of one mode, every bit but the mode's prefix
    drawn, laid out as one 4 x 16,384 level."""
    b = _bc7(mode)
    got = reference_bcn.decode_bc7(b, 4, 4 * N)
    theirs = native.decode_bc7(b.tobytes(), 4 * N, 4)
    off = (got != theirs).any((0, 2)).reshape(N, 4).any(1)
    # the blocks that differ, by partition (the 6 or 4 bits above the
    # mode's prefix; none in modes 4-6)
    bits = {0: 4, 1: 6, 2: 6, 3: 6, 7: 6}.get(mode, 0)
    word = b[off, 0].astype(np.int64) | (b[off, 1].astype(np.int64) << 8)
    parts = sorted(set(((word >> (mode + 1)) & ((1 << bits) - 1)).tolist()))
    assert not off.any(), f"{off.sum()} blocks differ, partitions {parts}"


@pytest.mark.parametrize("mode", range(8))
def test_bc7_decoder_equals_an_independent_one(mode):
    """Pillow's BC7 decoder, written apart from both, on the same
    blocks."""
    image = pytest.importorskip("PIL.Image")
    b = _bc7(mode)
    theirs = np.asarray(image.frombytes("RGBA", (4 * N, 4), b.tobytes(),
                                        "bcn", 7))
    assert np.array_equal(reference_bcn.decode_bc7(b, 4, 4 * N), theirs)


def test_bc7_reserved_mode_decodes_to_zeros():
    b = _bc7(6)
    b[:, 0] = 0
    got = reference_bcn.decode_bc7(b, 4, 4 * N)
    assert not got.any()
    assert np.array_equal(got, native.decode_bc7(b.tobytes(), 4 * N, 4))


def test_bc1_decoder_equals_the_ports_in_both_colour_modes():
    b = _bc1()
    c0 = b[:, 0] | (b[:, 1].astype(np.int64) << 8)
    c1 = b[:, 2] | (b[:, 3].astype(np.int64) << 8)
    assert 0.4 < (c0 <= c1).mean() < 0.6          # both modes, about half
    got = reference_bcn.decode_bc1(b, 4, 4 * N)
    assert np.array_equal(got, native.decode_bc1(b.tobytes(), 4 * N, 4))
    # the three-colour blocks' fourth colour is transparent black
    assert (got[..., 3] == 0).any() and (got[..., 3] == 255).any()


def test_bc1_decoder_is_within_one_of_an_independent_one():
    """Pillow's BC1 decoder, written apart from both, rounds the
    4-colour thirds down where the reference rounds them to nearest:
    within 1 on each colour channel there, equal in the 3-colour mode and
    in alpha."""
    image = pytest.importorskip("PIL.Image")
    b = _bc1()
    theirs = np.asarray(image.frombytes("RGBA", (4 * N, 4), b.tobytes(),
                                        "bcn", 1)).astype(np.int64)
    got = reference_bcn.decode_bc1(b, 4, 4 * N).astype(np.int64)
    c0 = b[:, 0] | (b[:, 1].astype(np.int64) << 8)
    c1 = b[:, 2] | (b[:, 3].astype(np.int64) << 8)
    three = np.repeat(c0 <= c1, 4)                 # texel columns
    assert np.array_equal(got[:, three], theirs[:, three])
    assert np.abs(got - theirs).max() == 1
    assert np.array_equal(got[..., 3], theirs[..., 3])


@pytest.mark.parametrize("h, w", [(1, 1), (2, 2), (1, 2), (6, 10), (8, 4)])
def test_levels_under_a_block_keep_their_top_left_texels(h, w):
    rng = np.random.default_rng([2**31 + 47, h, w])
    nb = -(-h // 4) * -(-w // 4)
    b7 = bcn.bc7_blocks(rng, nb, opaque=False)
    b1 = rng.integers(0, 256, (nb, 8), dtype=np.uint8)
    assert np.array_equal(reference_bcn.decode_bc7(b7, h, w),
                          native.decode_bc7(b7.tobytes(), w, h))
    assert np.array_equal(reference_bcn.decode_bc1(b1, h, w),
                          native.decode_bc1(b1.tobytes(), w, h))


def test_chains_are_seeded_whole_and_opaque():
    def chain(seed):
        return bcn.bc7_chain(np.random.default_rng(seed), (64, 32))

    a, b = chain(2**31 + 53), chain(2**31 + 53)
    assert [(h, w) for _, h, w in a] == [(64, 32), (32, 16), (16, 8),
                                         (8, 4), (4, 2), (2, 1), (1, 1)]
    for (ba, h, w), (bb, _, _) in zip(a, b):
        assert ba.shape == (-(-h // 4) * -(-w // 4), 16)
        assert np.array_equal(ba, bb)
        img = reference_bcn.decode_bc7(ba, h, w)
        assert (img[..., 3] == 255).all()
    assert not np.array_equal(a[0][0], chain(2**31 + 59)[0][0])
    modes = {(int(x) & -int(x)).bit_length() - 1 for x in a[0][0][:, 0]}
    assert modes == set(range(8))
    c1 = bcn.bc1_chain(np.random.default_rng(2**31 + 61), 16)
    assert [(x.shape, h, w) for x, h, w in c1] == [
        ((16, 8), 16, 16), ((4, 8), 8, 8), ((1, 8), 4, 4), ((1, 8), 2, 2),
        ((1, 8), 1, 1)]


# ---------------------------------------------- a small compressed world

BUILDER = '''"""The archive world with its textures shipped block-compressed:
the world's scene, every texture a seeded chain of the configuration's
``texture_format`` at its own size (``scenes/bcn.py``)."""

import numpy as np

from portbench.scenes import bcn, world


def build(cfg, seed):
    return bcn.compress(world.build(cfg, seed), cfg["texture_format"],
                        np.random.default_rng([seed, 0xBC]),
                        cfg.get("bc7_modes", range(8)))
'''

# configuration → (texture format, BC7 modes). ``world_bc7s_small`` stands
# in for ``world_bc7_small`` while the port decodes BC7 partition 63 of
# the two-subset modes (1, 3, 7) off the specification
# (``test_bc7_decoder_equals_the_ports``): its modes leave them out, and
# still build the hint pool (0 and 2 are partitioned).
CELLS = {"world_bc7_small": ("bc7", [0, 1, 2, 3, 4, 5, 6, 7]),
         "world_bc7s_small": ("bc7", [0, 2, 4, 5, 6]),
         "world_bc1_small": ("bc1", None)}


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    """A copy of ``portbench/`` with the compressed worlds added as new
    files and entries only → (Bench, its files' bytes before)."""
    top = tmp_path_factory.mktemp("bcn")
    root = top / "portbench"
    shutil.copytree(bench.ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "scenes" / "world_bcn.py").write_text(BUILDER)
    spec = json.loads(bench.SPEC.read_text())
    base = json.loads((root / "configs" / "world.json").read_text())
    for name, (pool, modes) in CELLS.items():
        cfg = dict(base, **small("world"), name=name, builder="world_bcn",
                   pool=pool, texture_format=pool)
        if modes:
            cfg["bc7_modes"] = modes
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        for traffic in ("orbit", "served"):
            cell = f"{name}.{traffic}"
            shutil.copy(root / "limits" / f"world.{traffic}.json",
                        root / "limits" / f"{cell}.json")
            spec["workloads"].append(dict(name=cell, config=name,
                                          traffic=traffic, chips=1,
                                          why="test"))
            for m in spec["end_to_end"]:
                if f"world.{traffic}" in m.get("workloads", []):
                    m["workloads"].append(cell)
    (top / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench.Bench(root, top / "BENCHMARK.json"), before


def _run(b, cell, seed=2**31 + 67):
    return bench.run_cell(cell, seed, 0.3, False, t_start=time.perf_counter(),
                          device="cpu", bench=b)


@pytest.mark.parametrize("traffic", ["orbit", "served"])
@pytest.mark.parametrize("config", list(CELLS))
def test_a_compressed_world_is_correct(compressed, config, traffic):
    b, before = compressed
    out = _run(b, f"{config}.{traffic}")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in
                                   b.end_to_end(f"{config}.{traffic}")}
    assert all(p.read_bytes() == v for p, v in before.items())


@pytest.mark.parametrize("config", ["world_bc7_small", "world_bc7s_small"])
def test_the_program_takes_the_chains_and_builds_the_hint_pool(compressed,
                                                               config):
    """The bc7 world's pool holds the asset's blocks, each row's first
    the block itself, and partitioned modes among them, so the hint pool
    is built."""
    from portbench import program

    b, _ = compressed
    cfg = b.config(config)
    arrays = builder(cfg["builder"], b.root).build(cfg, 2**31 + 71)
    assert arrays.chain_format == "bc7" and len(arrays.chains) == len(
        arrays.textures)
    _, scene = program.upload(arrays, cfg, torch.device("cpu"))
    assert scene.pool_mode == "bc7"
    assert set(scene.bc7_modes) == set(cfg["bc7_modes"])
    assert scene.aux_pool.shape[0] > 1               # the hint pool
    blocks = np.concatenate([lvl[0] for c in arrays.chains for lvl in c])
    assert np.array_equal(scene.mip_pool[:, :16].numpy(), blocks)


@pytest.mark.parametrize("traffic", ["orbit", "served"])
@pytest.mark.parametrize("fault, config", [
    ("bc7_subset0", "world_bc7s_small"),
    ("bc1_four_color", "world_bc1_small")])
def test_a_block_fault_fails_the_colour_number(compressed, monkeypatch,
                                               fault, config, traffic):
    b, _ = compressed
    faults.plant(monkeypatch.setattr, f"{config}.{traffic}", fault)
    out = _run(b, f"{config}.{traffic}", seed=2**31 + 73)
    assert out["correct"] is False, (fault, out["checks"])
    c = out["checks"]["color_off"]
    assert c["value"] > c["limit"], (fault, out["checks"])


@pytest.mark.parametrize("pool, fmt", [("bc7", None), ("bc1", None),
                                       ("bc7", "bc1"), ("tri", "bc7")])
def test_a_pool_without_its_chains_raises_in_set_up(compressed, pool, fmt):
    """A compressed pool without the builder's chains (the port would
    encode the textures itself), or chains under another pool."""
    b, _ = compressed
    name = "world" if fmt is None else f"world_{fmt}_small"
    with pytest.raises(ValueError, match="chains"):
        bench.run_cell(f"{name}.orbit", 2**31 + 79, 0.3, False,
                       t_start=time.perf_counter(), device="cpu", bench=b,
                       overrides=dict(small("world"), pool=pool))


# ------------------------------------- the reference without chains

# sha256 of (texels, level_off) and of one frame (RGBA, depth, covered,
# near-front pixels and colours) of reference.Scene in float64 at the
# small sizes, seed 2**31 + 7, yaw 33 degrees, t 0.25 s: recorded from
# the reference before it took compressed chains
DIGESTS = {
    "headline": (
        "7fa45bfc4dcbaefd847c23ec5aed0db3997d2127f29beabc9c762aaf5370574b",
        "59ab4c78f3aa37ad520dcbb217caae5ad4949d5a49da0425c81bcc88aba1ea0c"),
    "world": (
        "9239c46a99a7ef440f07f7ba9f9565ba16f27d3594895673114d4c00d273ba18",
        "2ab5c076ba0b54ee671e5c7356e2e1ecc013e6ce7f18f1e912718b479e365c99"),
}


def _sha(*arrays) -> str:
    return hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                   for a in arrays)).hexdigest()


@pytest.mark.parametrize("config", list(DIGESTS))
def test_the_reference_without_chains_is_unchanged(config):
    b = bench.Bench()
    cfg = dict(b.config(config), **small(config))
    arrays = builder(cfg["builder"]).build(cfg, 2**31 + 7)
    assert arrays.chains is None
    ref = reference.Scene(arrays, cfg, "cpu", torch.float64)
    vp = views.view_proj(cfg["camera"], cfg["width"], cfg["height"], 33.0)
    frame = ref.render(vp, reference.palette(arrays.animation, 0.25),
                       cfg["depth_tie"])
    got = (_sha(ref.texels.numpy(), ref.level_off.numpy()),
           _sha(*(x.numpy() for x in frame)))
    assert got == DIGESTS[config]
