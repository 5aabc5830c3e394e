"""Faults planted under the timed path, to show that the comparison
catches them (``tests/test_portbench_correct.py`` on the CPU, and
``calibrate.py --fault`` at a cell's own size on the card). The benchmark's
own runs plant nothing.

Each fault breaks the program where it produces its answer: the frame
engine's frame (``device.render_frame``, the orbit cells) or the loaded
artifact's request (``RenderArtifact.__call__``, the served cells); the
shade faults break the trilinear tap's level of detail, which both paths
reach through ``device._analytic_lod``, and the block faults break the
compressed pools' texel decode at sample time (``device._bc7_quad``,
``device._bc1_texel``), so a served cell must be exported after the
fault is planted.
"""

from __future__ import annotations

import dataclasses

import torch

# the frame faults any cell can have, the shade faults of a mipmapped
# cell, and the block faults of a cell on a bc7 or a bc1 pool
FRAME = ("stale", "half", "altered")
SHADE = ("lod_up", "mip_nearest")
BLOCK = ("bc7_subset0", "bc1_four_color")


def _alter(color):
    """Every pixel's red channel 8 levels off (bit 3 flipped), where it
    is produced."""
    if color.dtype == torch.int32:             # the packed frame
        return color ^ 8
    out = color.clone()
    out[..., 0] ^= 8
    return out


def _half(scene):
    """Every other triangle left out of the frame."""
    keep = torch.arange(scene.tri_vis.shape[0]) % 2 == 0
    return dataclasses.replace(scene, tri_vis=scene.tri_vis
                               & keep.to(scene.tri_vis.device))


def _plant_block(setattr_, device, fault: str) -> None:
    if fault == "bc7_subset0":
        real = device._bc7_quad

        def quad(words, hints, base, taps, modes):
            # each texel's subset id 0, the anchors kept: subset 0's
            # endpoints for every texel of a partitioned block
            if hints is not None:
                hints = [(torch.zeros_like(s), a) for s, a in hints]
            return real(words, hints, base, taps, modes)

        setattr_(device, "_bc7_quad", quad)
        return

    def texel(c0, c1, bits, xt, yt):
        # every block read as four-colour, c0 <= c1 or not
        code = ((bits >> (2 * ((yt & 3) * 4 + (xt & 3)))) & 3).to(
            torch.int32)
        out = []
        for a, b in zip(_rgb888(c0), _rgb888(c1)):
            p2 = torch.div(2 * a + b + 1, 3, rounding_mode="floor")
            p3 = torch.div(a + 2 * b + 1, 3, rounding_mode="floor")
            out.append(torch.where(code == 0, a, torch.where(
                code == 1, b, torch.where(code == 2, p2, p3))))
        return out + [torch.full_like(out[0], 255)]

    setattr_(device, "_bc1_texel", texel)


def _rgb888(c) -> list:
    """5:6:5 words → [r, g, b] 8-bit channels."""
    r, g, b = (c >> 11) & 31, (c >> 5) & 63, c & 31
    return [(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)]


def plant(setattr_, workload: str, fault: str) -> None:
    """Plant ``fault`` with ``setattr_(obj, name, value)`` (pytest's
    ``monkeypatch.setattr``, or ``setattr`` in a process that ends after
    the run).

    * ``stale``: the frame never moves on from the first;
    * ``half``: every other triangle left out;
    * ``altered``: every pixel's red channel 8 levels off;
    * ``lod_up``: the trilinear tap one mip level too coarse;
    * ``mip_nearest``: the nearer mip level alone, no blend between two;
    * ``bc7_subset0``: every texel of a bc7 pool decoded with its
      block's subset 0 endpoints;
    * ``bc1_four_color``: a bc1 pool's three-colour blocks (c0 <= c1)
      read as four-colour.
    """
    from mt_renderer_tpu_torch import serving
    from mt_renderer_tpu_torch.render import device

    if fault in BLOCK:
        _plant_block(setattr_, device, fault)
        return
    if fault in SHADE:
        real_lod = device._analytic_lod

        def lod(*a, **k):
            got = real_lod(*a, **k)
            return got + 1.0 if fault == "lod_up" else torch.floor(got)

        setattr_(device, "_analytic_lod", lod)
        return
    if fault not in FRAME:
        raise ValueError(f"unknown fault {fault!r}")
    served = workload.endswith("served")
    target = (serving.RenderArtifact, "__call__") if served else (
        device, "render_frame")
    real = getattr(*target)
    last = {}

    def broken(*args, **kw):
        args = list(args)
        if fault == "half":
            k = 1 if served else 0            # the scene argument
            args[k] = _half(args[k])
        out = real(*args, **kw)
        if fault == "stale":
            out = last.setdefault("out", out)   # state never moves on
        elif fault == "altered":
            out = (_alter(out[0]),) + tuple(out[1:])
        return out

    setattr_(*target, broken)
