"""The comparison that decides ``correct``.

Every kept frame of the window (``loops.Sampler``) is rendered again by
the plain reference, in float64, from the same scene arrays, view and
animation time, and held to it by three numbers, each the worst over the
kept frames:

* ``coverage_mismatch``: the share of pixels covered on one side only
  (the program's depth is exactly 1.0 where it covers nothing; the
  reference's winners);
* ``color_off``: the share of pixels whose RGBA8 colour is off by more
  than 1 in some channel from the reference's shade of every surface at
  the pixel whose depth lies within the configuration's ``depth_tie`` of
  the nearest. The program interpolates depth in float32 from edge
  functions at pixel coordinates up to 1920; where z is near 1 (the
  world's far buildings against the terrain, z about 0.9998) that depth
  errs by up to about 2e-5, so of two surfaces that close either may
  win, and a different winner is a different colour. That order is not
  judged here; the shade is: the right texels at the right mip levels,
  blended and tinted, for whichever of those surfaces the program shows;
* ``depth_gap_median``: the median of |z_program - z_reference| over
  the pixels both cover.

Each has a limit of its own, per cell, in ``portbench/limits/<cell>.json``
(``{"name": {"limit": x, "lower": ..., "upper": ..., "why": ...}}``),
set from the program's readings over a dozen seeds and the control's
(the reference in bfloat16 in the program's place;
``portbench/calibrate.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import reference

NAMES = ("coverage_mismatch", "color_off", "depth_gap_median")


def compare(rgba, depth, ref) -> dict:
    """One frame's numbers: the program's (H, W, 4) RGBA8 and (H, W)
    depth against ``ref`` = the reference's (RGBA8, depth, covered,
    near-front pixels (F,), their (F, 4) RGBA8); arrays or tensors."""
    def t(x):
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).cpu()

    ref_rgba, ref_depth, ref_cov, near_pix, near_rgba = map(t, ref)
    rgba, depth, ref_depth = t(rgba), t(depth).float(), ref_depth.float()
    cov = depth != 1.0
    flat = rgba.reshape(-1, 4).int()
    off = (flat - ref_rgba.reshape(-1, 4).int()).abs().amax(-1)
    near = (flat[near_pix] - near_rgba.int()).abs().amax(-1)
    off = off.scatter_reduce(0, near_pix, near, "amin")
    both = cov & ref_cov
    gap = (depth - ref_depth).abs()[both]
    return dict(
        coverage_mismatch=float((cov != ref_cov).float().mean()),
        color_off=float((off > 1).float().mean()),
        depth_gap_median=float(gap.median()) if gap.numel() else 0.0)


def judge(kept: list, arrays, cfg: dict, device) -> dict:
    """The worst of each number over the kept items, the reference run
    in float64 on ``device``, in blocks."""
    ref = reference.Scene(arrays, cfg, device, torch.float64)
    worst = dict.fromkeys(NAMES, 0.0)
    for rec in kept:
        pal = reference.palette(arrays.animation, rec["t"])
        nums = compare(rec["color"], rec["depth"],
                       ref.render(rec["vp"], pal, cfg["depth_tie"]))
        for k in NAMES:
            worst[k] = max(worst[k], nums[k])
    return worst


def reference_frames(kept: list, arrays, cfg: dict, device,
                     dtype=torch.bfloat16) -> list:
    """The reference in the program's place: the kept items' frames as
    it computes them in ``dtype``. In bfloat16 (the precision below the
    configuration's float32) this is the control."""
    ref = reference.Scene(arrays, cfg, device, dtype)
    out = []
    for rec in kept:
        pal = reference.palette(arrays.animation, rec["t"])
        rgba, depth, _ = ref.render(rec["vp"], pal)
        out.append(dict(rec, color=rgba.cpu().numpy(),
                        depth=depth.cpu().numpy()))
    return out


def limits(root: Path, workload: str) -> dict:
    """The cell's limits → {name: limit}; a cell without a file of
    limits cannot be judged."""
    path = root / "limits" / f"{workload}.json"
    return {k: float(v["limit"]) for k, v in
            json.loads(path.read_text()).items()}


def verdict(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": numbers[k], "limit": lim[k]} for k in NAMES}
    return all(numbers[k] <= lim[k] for k in NAMES), shown
