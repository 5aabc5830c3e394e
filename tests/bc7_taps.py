"""Seeded trilinear taps on small bc7 scenes: the cases on which the bc7
trilinear op (``device.bc7_trilinear``) is held to its plain twin, on
the CPU (``test_torch_bc7.py``) and on the card (``test_torch_gpu.py``).
Imports no JAX.

Each case is a bc7 scene uploaded from seeded blocks and a set of taps
over every texture (u and v a little beyond [0, 1], lod from below 0 to
past the last level, a quarter of the lods whole numbers):

* ``all_modes``: blocks of all eight modes, every ninth with byte 0
  zero (no mode), the hint pool built;
* ``partition63``: the partitioned modes 0-3 and 7 only, every block on
  its mode's last partition (63; 15 for mode 0);
* ``unlisted``: ``all_modes``' scene sampled with modes 2 and 5 left
  out of the list, so their blocks decode to zeros;
* ``tails``: 1x1 to 4x4 textures and lods past their last level, where
  the two levels are one;
* ``no_hint``: modes 4-6 only, so the scene has no hint pool.
"""

import dataclasses as dc

import numpy as np
import torch

from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.scene import demo

CASES = ("all_modes", "partition63", "unlisted", "tails", "no_hint")

_SIZES = {"tails": [(1, 1), (2, 3), (4, 4), (3, 1)]}
_MODES = {"partition63": (0, 1, 2, 3, 7), "no_hint": (4, 5, 6)}
_PARTITION_BITS = {0: 4, 1: 6, 2: 6, 3: 6, 7: 6}


def blocks(n: int, seed: int, modes=range(8), last_partition=False,
           no_mode_every: int = 0) -> np.ndarray:
    """(n, 16) random BC7 blocks of ``modes``: random bytes under a valid
    mode prefix, every third with bit 31 of word 3 set; with
    ``last_partition`` a partitioned block's partition field all ones,
    with ``no_mode_every`` every such block's byte 0 zero (from the
    middle one of the first such run)."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, 256, (n, 16), dtype=np.uint8)
    m = rng.choice(np.asarray(list(modes)), n)
    blk[:, 0] = ((1 << m) | ((blk[:, 0].astype(np.int64) << (m + 1))
                             & 0xFF)).astype(np.uint8)
    blk[::3, 15] |= 0x80
    if last_partition:
        for i, mode in enumerate(m):
            nbits = _PARTITION_BITS.get(int(mode), 0)
            word = int.from_bytes(blk[i].tobytes(), "little")
            word |= ((1 << nbits) - 1) << (int(mode) + 1)
            blk[i] = np.frombuffer(word.to_bytes(16, "little"), np.uint8)
    if no_mode_every:
        blk[no_mode_every // 2::no_mode_every, 0] = 0
    return blk


def scene(name: str, device):
    """The case's bc7 scene on ``device`` (its textures' chains of
    seeded blocks) → (scene, the modes to sample)."""
    batch = demo.build_demo_batch(instances=1, skinned=False)
    rng = np.random.default_rng(11)
    textures = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
                for h, w in _SIZES.get(name, [(37, 23), (16, 16), (5, 9)])]
    modes = _MODES.get(name, tuple(range(8)))
    chains = []
    for ti, t in enumerate(textures):
        ch = []
        for li, img in enumerate(td.mip_chain(t)):
            h, w = img.shape[:2]
            ch.append((blocks(((h + 3) // 4) * ((w + 3) // 4),
                              seed=97 * ti + li, modes=modes,
                              last_partition=name == "partition63",
                              no_mode_every=9 * (name == "all_modes")),
                       h, w))
        chains.append(ch)
    sc = td.upload(dc.replace(batch, textures=textures), "bc7",
                   device=device, bc7_chains=chains)
    listed = sc.bc7_modes
    if name == "unlisted":
        listed = tuple(m for m in listed if m not in (2, 5))
    return sc, listed


def taps(sc, n: int = 384, seed: int = 5) -> tuple:
    """``n`` taps on each texture of ``sc`` → (off0, th, tw, lod, u, v),
    each (textures * n,) on the scene's device."""
    rng = np.random.default_rng(seed)
    table = sc.mip_table[:, 0].cpu().numpy()
    k = len(table)
    u = rng.uniform(-0.1, 1.1, k * n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, k * n).astype(np.float32)
    lod = rng.uniform(-1.0, sc.num_mips + 1.0, k * n).astype(np.float32)
    lod[::4] = np.floor(lod[::4])
    const = np.repeat(table.astype(np.int32), n, axis=0)
    dev = sc.mip_pool.device
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (const[:, 0], const[:, 1], const[:, 2], lod, u, v))


def twin(sc, modes, off0, th, tw, lod, u, v) -> torch.Tensor:
    """The bc7 trilinear sample as the port computed it before the op:
    the levels, ``_mip_arith_bc1``, ``_bc7_trilinear_fused`` and the lerp
    → (4, n) f32."""
    big = torch.maximum(th, tw)
    mmax = torch.zeros_like(th)
    for m in range(1, sc.num_mips):
        mmax = torch.where((big >> m) > 0, m, mmax)
    lod = lod.clamp(0.0, float(sc.num_mips - 1))
    m0f = torch.floor(lod)
    fm = lod - m0f
    m0 = torch.minimum(td.rs._trunc_i32(m0f), mmax)
    m1 = torch.minimum(m0 + 1, mmax)
    hm1 = (th >> m1).clamp(min=1)
    wm1 = (tw >> m1).clamp(min=1)
    off_a, hm0, wm0 = td._mip_arith_bc1(off0, th, tw, m0, sc.num_mips)
    s0, s1 = td._bc7_trilinear_fused(sc.mip_pool, sc.aux_pool, modes, off_a,
                                     hm0, wm0, hm1, wm1, m0, m1, u, v)
    return torch.stack([a * (1 - fm) + b * fm for a, b in zip(s0, s1)])
