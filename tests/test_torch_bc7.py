"""Port vs reference: the bc7-resident texel pool and its host pieces.

``render/bcn.py``'s BC7 half (the NumPy copies, ``decode_bc7_device``,
``_bc7_weight``, ``bc7_texel_device``), ``native.decode_bc7`` with and
without the library, the bc7 pool build (``_build_bc7_pool``) and its
hint pool, ``upload(pool_mode="bc7", bc7_chains=)``, ``pool_stats`` and
the budget, the bc7 trilinear sampler (one 128 B row gather, the hint
row, eight texel decodes), the frames it feeds through the plain K1 and
K2 (single-layer mip, lit and unlit; split and ml peeled mip), for
mode-6 content and for random blocks of all eight modes,
``formats.tex``'s ``bc7_chain``, a JAX bc7 scene carried across, and
the op ``mtr::bc7_trilinear`` the sampler runs through (its CPU kernel
the plain twin, bit-equal to the sampler before the op on
``bc7_taps``' cases; its fake kernel; one node of a served program; the
CUDA kernel's tables).

Tolerance: none, every comparison bit for bit.
- Host code, the device decodes (integer torch ops), the pool builds and
  ``upload`` against the JAX package.
- The sampler against JAX's ``sample_trilinear`` on the same bc7 scene
  through the decoded footprints (integers) and fractions, which agree
  exactly, and the sample once JAX's einsum contraction is the port's
  sequential sum (as ``test_torch_bc1.py`` holds the bc1 sampler).
- Frames: the bc7 frame equals the frame of a pool of its decoded chains.

The JAX package reads BC7 two-subset partition 63 as 0100 0100 1101 1101
(``render/bcn.py`` ``_P2``, ``native/mtr_native.cpp`` ``kP2``); the
specification, and the port, read 0100 0100 0111 0111. So in this
process only, while these tests run, the JAX package decodes with the
specification's row (``_spec_partition63``): every other block is held
to the JAX package as it is, and partition-63 blocks to the
specification.
"""

import dataclasses as dc
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bc7_taps
from mt_renderer_tpu import native as jnative
from mt_renderer_tpu.formats import tex as jtex
from mt_renderer_tpu.render import bcn as jbcn
from mt_renderer_tpu.render import device as jd
from mt_renderer_tpu.scene import demo
from mt_renderer_tpu_torch import entry, serving
from mt_renderer_tpu_torch import native as tnative
from mt_renderer_tpu_torch.formats import tex as ttex
from mt_renderer_tpu_torch.render import bcn as tbcn
from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.utils import profiling
from test_torch_bc1 import alpha_batch
from test_torch_pools import assert_scene_equal
from test_torch_upload import SCENES
from torch_threads import one_thread  # noqa: F401

W, H = 128, 64
SIZES = [(37, 23), (1, 1), (5, 9), (3, 17), (64, 64)]


# two-subset partition 63 by the BC7 specification, and as the JAX
# package reads it (texels 8, 10, 12 and 14 in the other subset)
SPEC_P2_63 = np.array([0, 1, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1],
                      np.uint8)
JAX_P2_63 = np.array([0, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1],
                     np.uint8)
JAX_P2 = jbcn._P2          # the JAX package's own table, unpatched


@pytest.fixture(autouse=True, scope="module")
def _spec_partition63():
    """The JAX package, in this process and for this module only,
    decodes BC7 with the specification's partition 63: its ``_P2`` a
    copy with row 63 mended, its native BC7 decode through its own NumPy
    decoder (the path it takes without its library), JAX's compiled
    caches cleared on entry and on exit."""
    mended = jbcn._P2.copy()
    mended[63] = SPEC_P2_63
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbcn, "_P2", mended)
        mp.setattr(jnative, "decode_bc7", jbcn.decode_bc7_numpy)
        jax.clear_caches()
        yield
    jax.clear_caches()


def seeded_blocks(n: int, seed: int = 0, modes=range(8)) -> np.ndarray:
    """(n, 16) random BC7 blocks of ``modes`` (the reference's
    ``_random_chains`` recipe: random bytes under a valid mode prefix),
    every third with bit 31 of word 3 set."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    m = rng.choice(np.asarray(list(modes)), n)
    blk[:, 0] = ((1 << m) | ((blk[:, 0].astype(np.int64) << (m + 1))
                             & 0xFF)).astype(np.uint8)
    blk[::3, 15] |= 0x80
    return blk


def block_modes(blk: np.ndarray) -> np.ndarray:
    """Each block's mode: the lowest set bit of its first byte."""
    return np.array([(int(b) & -int(b)).bit_length() - 1 for b in blk[:, 0]])


def block_texels(blk: np.ndarray) -> np.ndarray:
    """(n, 16) blocks → (n, 16, 4) texels in block order, by the JAX
    package's NumPy decoder."""
    n = len(blk)
    img = jbcn.decode_bc7_numpy(blk.tobytes(), 4 * n, 4)
    return img.reshape(4, n, 4, 4).transpose(1, 0, 2, 3).reshape(n, 16, 4)


def random_chains(batch, seed: int = 5, modes=range(8)):
    """Per texture, its box-filter chain's level sizes filled with random
    blocks of ``modes`` → (bc7_chains, their decoded chains)."""
    bc7, dec = [], []
    for ti, t in enumerate(batch.textures):
        ch, dch = [], []
        for li, img in enumerate(td.mip_chain(t)):
            h, w = img.shape[:2]
            blk = seeded_blocks(((h + 3) // 4) * ((w + 3) // 4),
                                seed=seed + 31 * ti + li, modes=modes)
            ch.append((blk, h, w))
            dch.append(jbcn.decode_bc7_numpy(blk.tobytes(), w, h))
        bc7.append(ch)
        dec.append(dch)
    return bc7, dec


def mode6_chains(batch):
    """Each texture's box-filter chain, every level mode-6 encoded and
    decoded: the content a synthetic bc7 pool holds."""
    return [[jbcn.decode_bc7_numpy(jbcn.encode_bc7_mode6_numpy(img).tobytes(),
                                   img.shape[1], img.shape[0])
             for img in td.mip_chain(t)] for t in batch.textures]


# ------------------------------------------------------- host copies


def test_bc7_tables_match_reference():
    """Every table equals the JAX package's, but for two-subset
    partition 63, which is the specification's."""
    for name in ("_P2", "_P3", "_ANCHOR2_1", "_ANCHOR3_1", "_ANCHOR3_2"):
        np.testing.assert_array_equal(getattr(tbcn, name),
                                      getattr(jbcn, name), err_msg=name)
    np.testing.assert_array_equal(tbcn._P2[:63], JAX_P2[:63])
    np.testing.assert_array_equal(tbcn._P2[63], SPEC_P2_63)
    np.testing.assert_array_equal(JAX_P2[63], JAX_P2_63)
    assert tbcn._MODES == jbcn._MODES
    assert sorted(tbcn._WEIGHTS) == sorted(jbcn._WEIGHTS)
    for k in tbcn._WEIGHTS:
        np.testing.assert_array_equal(tbcn._WEIGHTS[k], jbcn._WEIGHTS[k])


@pytest.mark.parametrize("h,w", SIZES)
def test_bc7_numpy_copies_match_reference(h, w):
    nb = ((h + 3) // 4) * ((w + 3) // 4)
    blk = seeded_blocks(nb, seed=h * 100 + w)
    data = blk.tobytes()
    np.testing.assert_array_equal(tbcn.decode_bc7_numpy(data, w, h),
                                  jbcn.decode_bc7_numpy(data, w, h))
    rng = np.random.default_rng(h + w)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    enc = tbcn.encode_bc7_mode6_numpy(img)
    np.testing.assert_array_equal(enc, jbcn.encode_bc7_mode6_numpy(img))
    assert enc.shape == (nb, 16) and ((enc[:, 0] & 0x7F) == 0x40).all()
    np.testing.assert_array_equal(tbcn.bc7_block_hints(blk),
                                  jbcn.bc7_block_hints(blk))


def test_bc7_block_hints_every_partitioned_mode():
    blk = seeded_blocks(400, seed=3)
    got = tbcn.bc7_block_hints(blk)
    np.testing.assert_array_equal(got, jbcn.bc7_block_hints(blk))
    mode = block_modes(blk)
    assert got.dtype == np.uint32
    assert (got[np.isin(mode, (4, 5, 6))] == 0).all()
    assert (got[np.isin(mode, (1, 3, 7)), 1] >> 8 == 0).all()
    assert (got[np.isin(mode, (0, 2)), 1] >> 8 > 0).all()


@pytest.mark.parametrize("library", [True, False], ids=["native", "numpy"])
def test_native_decode_bc7_with_and_without_library(monkeypatch, library):
    """``native.decode_bc7`` through the built library and, with it
    forced absent, through the NumPy decoder: both equal the reference's
    decoder; ``available()`` says which path is live."""
    if not library:
        monkeypatch.setattr(tnative, "_load", lambda: None)
    assert tnative.available() is library
    for h, w in SIZES:
        blk = seeded_blocks(((h + 3) // 4) * ((w + 3) // 4), seed=h + w)
        np.testing.assert_array_equal(
            tnative.decode_bc7(blk.tobytes(), w, h),
            jbcn.decode_bc7_numpy(blk.tobytes(), w, h))
    with pytest.raises(ValueError, match="truncated"):
        tnative.decode_bc7(b"\0" * 16, 8, 8)


def test_tex_bc7_chain_matches_reference():
    blk = [seeded_blocks(((s + 3) // 4) ** 2, seed=s) for s in (16, 8, 4)]
    blob = ttex.write_texture(16, 16, int(ttex.TextureFormat.BC7),
                              [b.tobytes() for b in blk], levels=3)
    chain = ttex.TextureFile(blob).bc7_chain()
    want = jtex.TextureFile(blob).bc7_chain()
    assert len(chain) == len(want) == 3
    for (a, ah, aw), (b, bh, bw) in zip(chain, want):
        np.testing.assert_array_equal(a, b)
        assert (ah, aw) == (bh, bw) and a.shape[1] == 16
    bc1 = ttex.write_texture(8, 8, int(ttex.TextureFormat.BC1),
                             [b"\0" * 32])
    with pytest.raises(ValueError, match="BC7"):
        ttex.TextureFile(bc1).bc7_chain()


# ---------------------------------------------------- device decodes


def test_bc7_weight_matches_tables():
    for ib in (2, 3, 4):
        np.testing.assert_array_equal(
            tbcn._bc7_weight(torch.arange(1 << ib), ib).numpy(),
            tbcn._WEIGHTS[ib])
        np.testing.assert_array_equal(
            np.asarray(jbcn._bc7_weight(jnp.arange(1 << ib), ib)),
            tbcn._WEIGHTS[ib])


@pytest.mark.parametrize("h,w", SIZES)
def test_decode_bc7_device_matches_reference(h, w):
    """The integer torch decode against the NumPy decoder (and, at one
    size, the JAX device decoder, slow to run eagerly), on blocks of
    every mode with bit 31 of word 3 set."""
    nb = ((h + 3) // 4) * ((w + 3) // 4)
    blk = seeded_blocks(nb, seed=h * 7 + w)
    assert (blk[:, 15] >= 0x80).any()
    got = tbcn.decode_bc7_device(torch.from_numpy(blk.reshape(-1)), w, h)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  jbcn.decode_bc7_numpy(blk.tobytes(), w, h))
    if (h, w) == SIZES[0]:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jbcn.decode_bc7_device(blk.reshape(-1),
                                                           w, h)))
    host = tbcn.decode_bc7_device(blk.tobytes(), w, h, device="cpu")
    assert torch.equal(host, got)
    with pytest.raises(ValueError, match="device"):
        tbcn.decode_bc7_device(blk.tobytes(), w, h)


def _texels(blk, modes=tuple(range(8)), hint=False):
    """Every texel of every block by ``bc7_texel_device`` → (n, 16, 4)."""
    words = tbcn.bc7_words(torch.from_numpy(blk)[:, None])
    h = None
    if hint:
        hh = torch.from_numpy(tbcn.bc7_block_hints(blk).astype(np.int64))
        h = (hh[:, :1], hh[:, 1:])
    t = torch.arange(16)[None]
    return torch.stack(tbcn.bc7_texel_device(words, t, modes=modes, hint=h),
                       -1).numpy()


@pytest.mark.parametrize("mode", range(8))
def test_bc7_texel_device_each_mode(mode):
    """All 16 texels of blocks of one mode, with and without hints, with
    ``modes`` that mode alone and every mode."""
    blk = seeded_blocks(96, seed=40 + mode, modes=(mode,))
    want = block_texels(blk)
    for modes in ((mode,), tuple(range(8))):
        for hint in (False, True):
            np.testing.assert_array_equal(_texels(blk, modes, hint), want,
                                          err_msg=f"{modes} hint={hint}")


def test_bc7_texel_device_mixed_pruned_and_jax():
    """Mixed modes: every mode listed equals the decoder; ``modes``
    pruned to a subset decodes its blocks and leaves the rest zero; and
    JAX's ``bc7_texel_device`` gives the same integers, with and without
    hints."""
    blk = seeded_blocks(256, seed=9)
    want = block_texels(blk)
    mode = block_modes(blk)
    assert set(mode) == set(range(8))
    for hint in (False, True):
        np.testing.assert_array_equal(_texels(blk, hint=hint), want)
    sub = (1, 4, 6)
    got = _texels(blk, sub, hint=True)
    keep = np.isin(mode, sub)
    np.testing.assert_array_equal(got[keep], want[keep])
    assert (got[~keep] == 0).all()
    u = blk.astype(np.uint32)
    jw = [jnp.asarray((u[:, 4 * k] | (u[:, 4 * k + 1] << 8)
                       | (u[:, 4 * k + 2] << 16)
                       | (u[:, 4 * k + 3] << 24))[:, None]) for k in range(4)]
    hh = jbcn.bc7_block_hints(blk)
    t = jnp.arange(16, dtype=jnp.int32)[None]
    for hint in (None, (jnp.asarray(hh[:, :1]), jnp.asarray(hh[:, 1:]))):
        jt = np.stack([np.asarray(c) for c in jbcn.bc7_texel_device(
            jw, t, hint=hint)], -1)
        np.testing.assert_array_equal(jt, want)


def test_bc7_every_bit_offset():
    """Each block of every mode with each of its 128 bits flipped in turn
    (so every index, endpoint and p-bit field starts at every offset it
    can, across word boundaries and bit 31 of each word): the whole-level
    and the per-texel decodes equal the NumPy decoder."""
    base = np.concatenate([seeded_blocks(2, seed=70 + m, modes=(m,))
                           for m in range(8)])
    flips = np.repeat(base, 128, 0)
    bit = np.tile(np.arange(128), len(base))
    flips[np.arange(len(flips)), bit // 8] ^= (1 << (bit % 8)).astype(
        np.uint8)
    want = block_texels(flips)
    np.testing.assert_array_equal(_texels(flips, hint=True), want)
    got = tbcn.decode_bc7_device(torch.from_numpy(flips.reshape(-1)),
                                 4 * len(flips), 4).numpy()
    np.testing.assert_array_equal(
        got, jbcn.decode_bc7_numpy(flips.tobytes(), 4 * len(flips), 4))


def _set_bits(blk: np.ndarray, start: int, count: int, value: int) -> None:
    """Bits [start, start + count) of each (n, 16) block set to ``value``
    (0 or 1), bit 0 the lowest bit of byte 0."""
    for k in range(start, start + count):
        if value:
            blk[:, k // 8] |= np.uint8(1 << (k % 8))
        else:
            blk[:, k // 8] &= np.uint8(~(1 << (k % 8)) & 0xFF)


# per two-subset mode: (first endpoint bit, channels, bits an endpoint,
# first p-bit, p-bits per subset); endpoints run channel by channel,
# subset 0's two before subset 1's two
_TWO_SUBSET = {1: (8, 3, 6, 80, 1), 3: (10, 3, 7, 94, 2),
               7: (14, 4, 5, 94, 2)}


def _agreed_texels(blk: np.ndarray, mode: int) -> np.ndarray:
    """(n, 16) blocks of ``mode`` → (n, 16, 4) texels, once the NumPy,
    native and device decoders (whole level, and per texel with and
    without hints) are seen to agree on them."""
    n = len(blk)
    want = tbcn.decode_bc7_numpy(blk.tobytes(), 4 * n, 4)
    np.testing.assert_array_equal(
        tnative.decode_bc7(blk.tobytes(), 4 * n, 4), want)
    np.testing.assert_array_equal(tbcn.decode_bc7_device(
        torch.from_numpy(blk.reshape(-1)), 4 * n, 4).numpy(), want)
    texels = want.reshape(4, n, 4, 4).transpose(1, 0, 2, 3).reshape(n, 16, 4)
    for hint in (False, True):
        np.testing.assert_array_equal(_texels(blk, (mode,), hint), texels)
    return texels


@pytest.mark.parametrize("mode", sorted(_TWO_SUBSET))
def test_partition63_decodes_to_the_specification(mode):
    """4,096 random blocks of a two-subset mode, every one on partition
    63: the NumPy, native and device decoders agree. With subset 0's
    endpoints all zero bits and subset 1's all one bits (p-bits too),
    every texel of subset 0 decodes to 0 and of subset 1 to 255 whatever
    its index, so the texels show the specification's row."""
    assert tnative.available()
    blk = seeded_blocks(4096, seed=90 + mode, modes=(mode,))
    _set_bits(blk, mode + 1, 6, 1)                  # partition 63
    _agreed_texels(blk, mode)
    start, chans, cb, p0, npb = _TWO_SUBSET[mode]
    for c in range(chans):
        for e in range(4):
            _set_bits(blk, start + (4 * c + e) * cb, cb, e // 2)
    for k in range(2 * npb):
        _set_bits(blk, p0 + k, 1, k // npb)
    texels = _agreed_texels(blk, mode)
    assert set(np.unique(texels)) == {0, 255}
    assert (texels[..., :3] == 255 * SPEC_P2_63[None, :, None]).all()
    if mode == 7:                                   # alpha by subset too
        assert (texels[..., 3] == 255 * SPEC_P2_63[None]).all()
    else:
        assert (texels[..., 3] == 255).all()


# ------------------------------------------------------------ the pool


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bc7_upload_matches_jax_leaf_by_leaf(name):
    """Mode-6 content: every leaf (``aux_pool`` the (1, 128) zero row)
    and ``bc7_modes == (6,)``, as in the JAX package."""
    batch = SCENES[name]()
    ts = td.upload(batch, "bc7", device="cpu")
    assert tuple(ts.mip_pool.shape[1:]) == (128,)
    assert_scene_equal(ts, jd.upload(batch, pool_mode="bc7"))
    if batch.textures:
        assert ts.bc7_modes == (6,)
    assert tuple(ts.aux_pool.shape) == (1, 128)


def test_bc7_chains_upload_matches_jax_leaf_by_leaf():
    """Random blocks of all eight modes through ``bc7_chains``: the hint
    pool is built and every leaf equals the JAX package's."""
    batch = two_texture_demo()
    chains, _ = random_chains(batch)
    ts = td.upload(batch, "bc7", device="cpu", bc7_chains=chains)
    assert ts.bc7_modes == tuple(range(8)) and ts.aux_pool.shape[0] > 1
    assert_scene_equal(ts, jd.upload(batch, pool_mode="bc7",
                                     bc7_chains=chains))


def two_texture_demo():
    """The demo batch with a second, 37x23 texture on every other
    instance's triangles (odd extents in one pool)."""
    batch = demo.build_demo_batch(instances=4, skinned=False)
    rng = np.random.default_rng(2)
    t2 = rng.integers(0, 256, (37, 23, 4), dtype=np.uint8)
    t2[..., 3] = 255
    tex = batch.tri_texture.copy()
    tex[len(tex) // 2:] = np.where(tex[len(tex) // 2:] >= 0, 1, -1)
    return dc.replace(batch, textures=[batch.textures[0], t2],
                      tri_texture=tex)


@pytest.mark.parametrize("chunk", [None, 64])
def test_build_bc7_pool_matches_jax(monkeypatch, chunk):
    """Seeded compact blocks over odd levels, built in one step and in
    many small ones (the last step's start clamped back)."""
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
    got = td._build_bc7_pool(torch.from_numpy(cpool), segs)
    want = np.asarray(jd._build_bc7_pool(jnp.asarray(cpool), segs))
    assert tuple(got.shape) == (off, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hint_bytes_are_packed_explicitly():
    """The hint pool's bytes come from shifts and masks, not from the
    words' memory (the reference's ``.view(np.uint8)``, which assumes a
    little-endian host): the same bytes from big-endian words, equal to
    the little-endian view."""
    hints = jbcn.bc7_block_hints(seeded_blocks(64, seed=1))
    got = td._hint_bytes(hints)
    assert got.shape == (64, 8) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, hints.astype("<u4").view(np.uint8))
    np.testing.assert_array_equal(td._hint_bytes(hints.astype(">u4")), got)
    np.testing.assert_array_equal(got[:, 4], hints[:, 1] & 0xFF)


@pytest.mark.parametrize("content", ["mode6", "all_modes"])
def test_bc7_pool_stats_match_jax(content):
    """Rows are blocks (not halved), 128 B resident and 16 B uploaded a
    block, plus the hint pool's 64 B and 8 B where it exists."""
    batch = two_texture_demo()
    kw = ({} if content == "mode6"
          else dict(bc7_chains=random_chains(batch)[0]))
    got = td.pool_stats(td.upload(batch, "bc7", device="cpu", **kw))
    assert got == jd.pool_stats(jd.upload(batch, pool_mode="bc7", **kw))
    blocks = got["rows"]
    hint = 0 if content == "mode6" else (blocks + 1) // 2 * 128
    assert got["bytes"] == blocks * 128 + hint
    assert got["upload_bytes"] == blocks * (16 if content == "mode6" else 24)


def test_bc7_budget_charges_once_and_hints_only_when_built():
    """The budget charges the 128 B rows once (the JAX package charges
    them twice) and the hint pool's 64 B a block only when a partitioned
    mode is present (the JAX package always charges it)."""
    batch = demo.build_demo_batch(instances=4, skinned=False)
    blocks = sum(max(64 >> i, 4) ** 2 // 16 for i in range(5)) + 1 + 1
    assert td.upload(batch, "bc7", device="cpu",
                     pool_budget_bytes=blocks * 128).pool_mode == "bc7"
    with pytest.raises(MemoryError):        # x2 and the hint share
        jd.upload(batch, "bc7", pool_budget_bytes=blocks * 128)
    with pytest.raises(MemoryError, match="charged once.*hint pool.*absent"):
        td.upload(batch, "bc7", device="cpu",
                  pool_budget_bytes=blocks * 128 - 1)
    six, _ = random_chains(batch, modes=(4, 5, 6))
    assert td.upload(batch, "bc7", device="cpu", bc7_chains=six,
                     pool_budget_bytes=blocks * 128).bc7_modes == (4, 5, 6)
    every, _ = random_chains(batch)
    scene = td.upload(batch, "bc7", device="cpu", bc7_chains=every,
                      pool_budget_bytes=blocks * 192)
    assert scene.aux_pool.shape[0] > 1
    with pytest.raises(MemoryError, match="present"):
        td.upload(batch, "bc7", device="cpu", bc7_chains=every,
                  pool_budget_bytes=blocks * 192 - 1)


def test_bc7_pool_bias_matches_jax():
    batch = alpha_batch(instances=4, subdiv=0)
    assert_scene_equal(td.upload(batch, "bc7", device="cpu", pool_bias=2),
                       jd.upload(batch, pool_mode="bc7", pool_bias=2))


def test_bc7_upload_refusals():
    batch = demo.build_demo_batch(instances=4, skinned=False)
    chains, dec = random_chains(batch)
    with pytest.raises(ValueError, match="pool_mode='bc7'"):
        td.upload(batch, "bc1", device="cpu", bc7_chains=chains)
    with pytest.raises(ValueError, match="not both"):
        td.upload(batch, "bc7", device="cpu", bc7_chains=chains,
                  mip_chains=dec)
    bad = [[(np.concatenate([b, b[:1]]), h, w) for b, h, w in chains[0]]]
    with pytest.raises(ValueError, match="blocks"):
        td.upload(batch, "bc7", device="cpu", bc7_chains=bad)


# --------------------------------------------------------- the sampler


def _odd_batch(seed: int = 1):
    batch = demo.build_demo_batch(instances=4, skinned=False)
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 256, (37, 23, 4)).astype(np.uint8)
    return dc.replace(batch, textures=[t]), rng


def _sweep(rng, num_mips: int, n: int = 48):
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
        mode=scene.pool_mode, aux=scene.aux_pool,
        bc7_modes=scene.bc7_modes), -1)


@pytest.mark.parametrize("content", ["mode6", "all_modes"])
def test_bc7_sampler_dense_sweep_matches_jax(monkeypatch, content):
    """JAX's ``sample_trilinear`` and the port's sampler on the same bc7
    scene over a dense (u, v, lod) sweep on a 37x23 texture."""
    batch, rng = _odd_batch()
    kw = ({} if content == "mode6"
          else dict(bc7_chains=random_chains(batch)[0]))
    js = jd.upload(batch, pool_mode="bc7", **kw)
    ts = td.upload(batch, "bc7", device="cpu", **kw)
    assert_scene_equal(ts, js)
    u, v, lod = _sweep(rng, ts.num_mips)
    seen = {"jax": [], "port": []}
    tcontract = td._contract_quad

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
    want = np.asarray(jd.sample_trilinear(js, layer, jnp.asarray(u),
                                          jnp.asarray(v), jnp.asarray(lod)))
    got = _port_sample(ts, u, v, lod).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(seen["jax"]) == len(seen["port"]) == 2   # child, parent
    # the port samples the taps flattened (``bc7_trilinear``)
    for (gq, gx, gy), (wq, wx, wy) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(gq, wq.reshape(gq.shape))
        np.testing.assert_array_equal(gx, wx.reshape(gx.shape))
        np.testing.assert_array_equal(gy, wy.reshape(gy.shape))


@pytest.mark.parametrize("mode", ["quad", "narrow", "tri"])
def test_bc7_sampler_equals_decoded_chains(mode):
    """The reference's contract: the bc7 sample (mode-6 and all-mode
    content) equals, bit for bit, the sample of a texel pool holding the
    BC7-decoded chains, at fractional and integer lods."""
    batch, rng = _odd_batch(seed=3)
    chains, dec = random_chains(batch, seed=8)
    for bc7, ref in (
            (td.upload(batch, "bc7", device="cpu"),
             td.upload(batch, mode, device="cpu",
                       mip_chains=mode6_chains(batch))),
            (td.upload(batch, "bc7", device="cpu", bc7_chains=chains),
             td.upload(batch, mode, device="cpu", mip_chains=dec))):
        u, v, lod = _sweep(rng, bc7.num_mips)
        for ld in (lod, np.floor(lod)):
            assert torch.equal(_port_sample(bc7, u, v, ld),
                               _port_sample(ref, u, v, ld))


def test_bc7_asset_passthrough_matches_jax():
    """A BC7 ``.tex`` asset's own, partial mip chain (random blocks of all
    modes, 32 down to 4, not box-filter related) uploads verbatim: the
    child lanes hold the asset's blocks, the scene equals the JAX
    package's upload of the same chain, and sampling equals a quad pool
    of the asset's decoded levels."""
    blk = [seeded_blocks(((s + 3) // 4) ** 2, seed=s) for s in (32, 16, 8, 4)]
    blob = ttex.write_texture(32, 32, int(ttex.TextureFormat.BC7),
                              [b.tobytes() for b in blk], levels=4)
    chain = ttex.TextureFile(blob).bc7_chain()
    jchain = jtex.TextureFile(blob).bc7_chain()
    batch = demo.build_demo_batch(instances=4, skinned=False)
    bc7 = td.upload(batch, "bc7", device="cpu", bc7_chains=[chain])
    assert bc7.num_mips == 4 and bc7.bc7_modes == tuple(range(8))
    assert_scene_equal(bc7, jd.upload(batch, pool_mode="bc7",
                                      bc7_chains=[jchain]))
    pool = bc7.mip_pool.numpy()
    for lv, (blocks, _h, _w) in enumerate(chain):
        np.testing.assert_array_equal(pool[bc7.mip_table[0, lv, 0], :16],
                                      blocks[0])
    dec = [tnative.decode_bc7(np.ascontiguousarray(b).tobytes(), w, h)
           for b, h, w in chain]
    quad = td.upload(batch, device="cpu", mip_chains=[dec])
    u, v, lod = _sweep(np.random.default_rng(7), 4)
    assert torch.equal(_port_sample(bc7, u, v, lod),
                       _port_sample(quad, u, v, lod))


# ------------------------------------------------------------- frames


@pytest.fixture(scope="module")
def frames():
    """The punch-through demo scene as mode-6 and all-mode bc7 pools, and
    quad pools of their decoded chains; its view and bones."""
    batch = alpha_batch()
    chains, dec = random_chains(batch, seed=12)
    vp = np.asarray(demo.demo_camera(9, W, H).view_proj())
    return dict(batch=batch, vp=vp, bones=demo.demo_bone_mats(0.4), pairs={
        "mode6": (td.upload(batch, "bc7", device="cpu"),
                  td.upload(batch, device="cpu",
                            mip_chains=mode6_chains(batch))),
        "all_modes": (td.upload(batch, "bc7", device="cpu",
                                bc7_chains=chains),
                      td.upload(batch, device="cpu", mip_chains=dec))})


@pytest.mark.parametrize("content", ["mode6", "all_modes"])
@pytest.mark.parametrize("lighting", [False, True])
def test_bc7_mip_frame_equals_decoded_chains(frames, content, lighting):
    bc7, quad = frames["pairs"][content]
    kw = dict(width=W, height=H, packed=True, mipmap=True,
              lighting=lighting, tap_tiles=td.auto_tap_tiles(
                  frames["batch"], frames["vp"], frames["bones"], width=W,
                  height=H))
    got, gd = td.render_frame(bc7, frames["vp"], frames["bones"], **kw)
    want, wd = td.render_frame(quad, frames["vp"], frames["bones"], **kw)
    tr.flush_overflow_checks()
    assert torch.equal(got, want) and torch.equal(gd, wd)
    assert 0.05 < float((wd < 1.0).float().mean()) < 0.95


@pytest.mark.parametrize("content", ["mode6", "all_modes"])
@pytest.mark.parametrize("peel_mode", ["split", "ml"])
def test_bc7_peeled_mip_frame_equals_decoded_chains(frames, content,
                                                    peel_mode):
    """Translucent texels send the textured triangles through K2 (mtap)
    and the composite."""
    bc7, quad = frames["pairs"][content]
    kw = dict(width=W, height=H, layers=3, peel_mode=peel_mode,
              packed=True, mipmap=True, lighting=True)
    caps = td.measure_live_tap_tiles(bc7, frames["vp"], frames["bones"],
                                     width=W, height=H, layers=3,
                                     lighting=True, mode=peel_mode)
    got, gd = td.render_frame_peeled(bc7, frames["vp"], frames["bones"],
                                     tap_tiles=caps, **kw)
    want, wd = td.render_frame_peeled(quad, frames["vp"], frames["bones"],
                                      tap_tiles=caps, **kw)
    tr.flush_overflow_checks()
    assert torch.equal(got, want) and torch.equal(gd, wd)
    assert float(bc7.cols_const[9].min()) == 0.0   # translucent


def test_mode6_opacity_flag_is_the_source_textures():
    """An opaque texture's mode-6 content: the pool's opacity flag
    (``cols_const`` row 9) is the source texture's, opaque, as in the
    JAX package, while mode 6 rounds some alpha of 255 to 254, so a pool
    of the decoded chains flags it translucent; the split-peeled frames
    of the two then differ, and agree once the decoded chains' pool
    takes the bc7 pool's flags (the texels are equal)."""
    batch = demo.make_translucent(demo.build_demo_batch(
        instances=9, skinned=True, subdiv=1), 9)
    dec = mode6_chains(batch)
    assert (dec[0][0][..., 3] == 254).any()
    bc7 = td.upload(batch, "bc7", device="cpu")
    ref = td.upload(batch, device="cpu", mip_chains=dec)
    js = jd.upload(batch, pool_mode="bc7")
    np.testing.assert_array_equal(bc7.cols_const.numpy(),
                                  np.asarray(js.cols_const))
    textured = bc7.cols_const[0] >= 0
    assert bool((bc7.cols_const[9][textured] == 1).all())
    assert bool((ref.cols_const[9][textured] == 0).all())
    cam = demo.demo_camera(9, W, H)
    cam.position = cam.position * 0.3
    vp, bones = np.asarray(cam.view_proj()), demo.demo_bone_mats(0.5)
    kw = dict(width=W, height=H, layers=3, peel_mode="split", packed=True,
              mipmap=True, lighting=True)
    got, _ = td.render_frame_peeled(bc7, vp, bones, **kw)
    other, _ = td.render_frame_peeled(ref, vp, bones, **kw)
    same = td.render_frame_peeled(dc.replace(ref, cols_const=torch.cat(
        [ref.cols_const[:9], bc7.cols_const[9:]])), vp, bones, **kw)[0]
    tr.flush_overflow_checks()
    assert not torch.equal(got, other) and torch.equal(got, same)


def test_bc7_tap_paths_raise(frames):
    bc7 = frames["pairs"]["mode6"][0]
    for fn, kw in ((td.render_frame, {}),
                   (td.render_frame_peeled, dict(layers=2,
                                                 peel_mode="split")),
                   (td.render_frame_peeled, dict(layers=2))):
        with pytest.raises(ValueError, match="bc7 pools.*mipmap"):
            fn(bc7, frames["vp"], frames["bones"], width=W, height=H, **kw)


@pytest.mark.parametrize("content", ["mode6", "all_modes"])
def test_carried_jax_bc7_scene_renders_the_ports_frame(frames, content):
    """A JAX bc7 scene (its hint pool and ``bc7_modes`` included) carried
    across by ``scene_from_numpy`` renders the port's own bc7 frame."""
    kw = ({} if content == "mode6"
          else dict(bc7_chains=random_chains(frames["batch"], seed=12)[0]))
    js = jd.upload(frames["batch"], pool_mode="bc7", **kw)
    leaves = {f: np.asarray(getattr(js, f)) for f in td.TENSOR_FIELDS}
    statics = {f: getattr(js, f) for f in td.STATIC_FIELDS}
    carried = td.scene_from_numpy(leaves, statics, "cpu")
    own = frames["pairs"][content][0]
    assert carried.bc7_modes == own.bc7_modes
    fkw = dict(width=W, height=H, packed=True, mipmap=True)
    got, _ = td.render_frame(carried, frames["vp"], frames["bones"], **fkw)
    want, _ = td.render_frame(own, frames["vp"], frames["bones"], **fkw)
    tr.flush_overflow_checks()
    assert torch.equal(got, want)
    leaves["aux_pool"] = leaves["aux_pool"].reshape(-1, 64)
    with pytest.raises(ValueError, match="aux_pool has u8 rows of 128 B"):
        td.scene_from_numpy(leaves, statics, "cpu")


def test_bc7_world_frame_equals_decoded_chains():
    """A small archive world (mixed texture sizes in one pool) from
    ``entry.world_case(pool_mode="bc7")``: mode-6 content, and its frame
    equals the quad pool of its decoded chains."""
    case = entry.world_case("cpu", buildings=8, width=W, height=96,
                            characters=2, variants=3, terrain_subdiv=2,
                            building_subdivs=(1,), pool_mode="bc7")
    quad = td.upload(case.batch, device="cpu",
                     mip_chains=mode6_chains(case.batch))
    vp, pal = case.view_proj(), case.bone_mats(6.0)
    kw = dict(width=W, height=96, packed=True, mipmap=True)
    got, _ = td.render_frame(case.scene, vp, pal, **kw)
    want, depth = td.render_frame(quad, vp, pal, **kw)
    tr.flush_overflow_checks()
    assert case.scene.bc7_modes == (6,) and len(case.batch.textures) > 2
    assert torch.equal(got, want) and bool((depth < 1.0).any())


def test_frame_profile_runs_the_bc7_world(capsys):
    """``frame_profile --world --mipmap --pool bc7`` rehearses on CPU
    tensors at a small size, the pool build's rebuild included."""
    from mt_renderer_tpu_torch import frame_profile

    assert frame_profile.main(
        ["--device", "cpu", "--world", "--buildings", "4", "--mipmap",
         "--pool", "bc7", "--width", "128", "--height", "64", "--views",
         "1", "--frames", "1", "--prof-frames", "1"]) == 0
    out = capsys.readouterr().out
    assert '"pool_mode": "bc7"' in out
    assert "pool build (bc7, on the device at upload)" in out
    assert "the rebuild equals the pool: True" in out


# ------------------------------------------- the op mtr::bc7_trilinear


class _Ops(TorchDispatchMode):
    """Records the name of every op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", bc7_taps.CASES)
def test_bc7_trilinear_dispatches_through_the_op_and_equals_the_twin(case):
    """``_trilinear_arith(mode="bc7")`` runs one ``mtr::bc7_trilinear``,
    and on the CPU equals, bit for bit, the sampler as it was before the
    op (the levels, ``_bc7_trilinear_fused``, the lerp), on blocks of
    every mode, partition-63 blocks, modes left out of the list (which
    decode to zeros), 1x1 to 4x4 tail levels where m1 == m0, and scenes
    with and without a hint pool."""
    sc, modes = bc7_taps.scene(case, "cpu")
    taps = bc7_taps.taps(sc)
    with _Ops() as ops:
        got = td._trilinear_arith(sc.mip_pool, *taps, sc.num_mips,
                                  mode="bc7", aux=sc.aux_pool,
                                  bc7_modes=modes)
    assert [f for f in ops.seen if f.startswith("mtr.")] == [
        "mtr.bc7_trilinear.default"]
    want = bc7_taps.twin(sc, modes, *taps)
    assert torch.equal(torch.stack(got), want)
    assert (sc.aux_pool.shape[0] == 1) == (case == "no_hint")
    if case == "unlisted":
        every = bc7_taps.twin(sc, sc.bc7_modes, *taps)
        assert not torch.equal(want, every)
    if case == "tails":
        th, tw, lod = taps[1], taps[2], taps[3]
        last = (torch.maximum(th, tw).float().log2().floor()
                <= lod.clamp(min=0).floor())
        assert bool(last.any()) and bool((~last).any())


def test_bc7_trilinear_fake_kernel_and_opcheck():
    """The op's fake kernel gives the CPU kernel's shape and dtype, and
    ``torch.library.opcheck`` passes on the CPU, with and without the
    hint pool."""
    for case in ("all_modes", "no_hint"):
        sc, modes = bc7_taps.scene(case, "cpu")
        taps = bc7_taps.taps(sc, n=24)
        aux = sc.aux_pool if td._bc7_needs_hint(modes) else None
        args = (sc.mip_pool, aux, *taps, sc.num_mips, list(modes))
        real = td.BC7_OP(*args)
        fake = td._bc7_op_fake(*args)
        assert fake.shape == real.shape == (4, taps[0].shape[0])
        assert fake.dtype == real.dtype == torch.float32
        torch.library.opcheck(td.BC7_OP, args)


def test_bc7_trilinear_refuses_bad_taps():
    sc, modes = bc7_taps.scene("all_modes", "cpu")
    off0, th, tw, lod, u, v = bc7_taps.taps(sc, n=8)
    with pytest.raises(ValueError, match="hint pool"):
        td.bc7_trilinear_reference(sc.mip_pool, None, off0, th, tw, lod, u,
                                   v, sc.num_mips, modes)
    with pytest.raises(ValueError, match="lod must be"):
        td.bc7_trilinear_reference(sc.mip_pool, sc.aux_pool, off0, th, tw,
                                   lod.double(), u, v, sc.num_mips, modes)


def test_served_bc7_program_holds_the_op_as_one_node():
    """``serving.export_render`` of a small mipmapped bc7 scene holds
    ``mtr::bc7_trilinear`` as one node, and the loaded program's frame
    equals ``render_frame``'s."""
    case = entry.demo_case("cpu", instances=4, subdiv=1, width=64,
                           height=64, pool_mode="bc7")
    art = serving.load_render(serving.export_render(
        case.scene, width=64, height=64, mipmap=True))
    targets = [str(n.target) for n in art._program.graph.nodes
               if n.op == "call_function"]
    assert sum("bc7_trilinear" in t for t in targets) == 1
    vp, bones = case.view_proj(), case.bone_mats(0.3)
    color, depth = art(case.scene, vp, bones)
    want, wdepth = td.render_frame(case.scene, vp, bones, width=64,
                                   height=64, mipmap=True)
    tr.flush_overflow_checks()
    assert torch.equal(depth, wdepth) and bool((depth < 1.0).any())
    assert torch.equal(color, want)


def test_kernel_taps_are_counted_only_on_the_card():
    """Under a profiler, a bc7 sample on the CPU counts no
    ``bc7.kernel_taps``: the plain twin ran, not the kernel."""
    sc, modes = bc7_taps.scene("no_hint", "cpu")
    taps = bc7_taps.taps(sc, n=8)
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        td._trilinear_arith(sc.mip_pool, *taps, sc.num_mips, mode="bc7",
                            aux=sc.aux_pool, bc7_modes=modes)
    assert "bc7.kernel_taps" not in profiling.count_totals()
    profiling.reset_spans()


def _cu_table(src: str, name: str) -> list:
    body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
    return [int(x) for x in body.replace("\n", " ").split(",") if x.strip()]


def test_bc7_kernel_source_holds_the_specifications_tables():
    """The CUDA kernel's weight tables and per-mode field widths (it runs
    only on the card) equal ``render/bcn.py``'s."""
    src = (Path(td.__file__).parents[1] / "csrc" /
           "bc7_trilinear.cu").read_text()
    for ib in (2, 3, 4):
        assert _cu_table(src, f"kWeight{ib}") == tbcn._WEIGHTS[ib].tolist()
    modes = dict(re.findall(r"struct Mode<(\d)> : Fields<([^>]*)>", src))
    assert sorted(modes) == [str(m) for m in range(8)]
    for m, fields in modes.items():
        got = tuple(int(x == "true") if x in ("true", "false") else int(x)
                    for x in (f.strip() for f in fields.split(",")))
        assert got == tuple(int(x) for x in tbcn._MODES[int(m)]), m
