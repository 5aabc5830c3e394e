"""Timeline animation — rScheduler tracks driving per-frame parameters.

The reference parses scheduler files but discards the result
(``src/rscheduler.rs:217`` returns an empty struct); the
track/keyframe model here is the same, plus actual evaluation:

* host sampling with step or linear interpolation (keyframe mode byte:
  0 = step, nonzero = linear — the reference never interprets modes, so
  linear-by-default-for-floats is this framework's convention);
* device sampling: FLOAT tracks become ``(frames, values, linear)``
  tensors sampled with ``torch.searchsorted`` + lerp on an explicit
  device, so a whole animated bone palette evaluates on the card per
  frame without leaving it;
* a ``BoneAnimator`` mapping the convention-named tracks
  ``joint<N>:<rx|ry|rz|tx|ty|tz>`` onto skeleton local-transform deltas.

Every device function is elementwise f32 torch ops in one fixed order,
and the Euler angles' cos and sin run in f64 and round once to f32, so
the host palette (``bone_mats``: the same ops on the CPU) and the card's
(``bone_mats_device``) agree bit for bit.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..formats.sdl import SchedulerFile, Track, TrackType
from .skeleton import Skeleton

_JOINT_RE = re.compile(r"^joint(\d+):(rx|ry|rz|tx|ty|tz)$")
_PARAMS = ("rx", "ry", "rz", "tx", "ty", "tz")


def sample_track(track: Track, frame: float):
    """Host-side sample with step/linear interpolation."""
    keys = track.keys
    if not keys:
        return None
    if frame <= keys[0].frame:
        return keys[0].value
    for a, b in zip(keys, keys[1:]):
        if frame < b.frame:
            if (
                track.track_type == TrackType.TYPE_FLOAT
                and a.mode != 0
                and b.frame > a.frame
            ):
                t = (frame - a.frame) / (b.frame - a.frame)
                return float(a.value) + t * (float(b.value) - float(a.value))
            return a.value
    return keys[-1].value


def track_arrays(track: Track) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FLOAT track → (frames f32, values f32, linear f32) arrays."""
    frames = np.array([k.frame for k in track.keys], np.float32)
    values = np.array([float(k.value) for k in track.keys], np.float32)
    linear = np.array([float(k.mode != 0) for k in track.keys], np.float32)
    return frames, values, linear


def sample_device(frames: torch.Tensor, values: torch.Tensor,
                  linear: torch.Tensor, t) -> torch.Tensor:
    """Step/linear sample of one track at scalar time ``t`` (a float or a
    0-d tensor) on the tracks' device → 0-d f32 tensor."""
    n = frames.shape[0]
    t = torch.as_tensor(t, dtype=torch.float32, device=frames.device)
    i = (torch.searchsorted(frames, t.reshape(1), right=True)[0] - 1).clamp(
        0, n - 1)
    j = (i + 1).clamp(max=n - 1)
    f0 = frames[i]
    f1 = frames[j]
    span = torch.where(f1 > f0, f1 - f0, 1.0)
    u = ((t - f0) / span).clamp(0.0, 1.0)
    lerped = values[i] + u * (values[j] - values[i])
    stepped = values[i]
    out = torch.where((linear[i] > 0) & (j > i), lerped, stepped)
    return torch.where(t < frames[0], values[0], out)


def _tracks_on(arrays: dict, device) -> dict:
    """``{key: (frames, values, linear)}`` NumPy arrays → f32 tensors on
    ``device``."""
    return {k: tuple(torch.as_tensor(a, device=device) for a in v)
            for k, v in arrays.items()}


class Timeline:
    """All tracks of one scheduler, sampled by name."""

    def __init__(self, sdl: SchedulerFile):
        self.sdl = sdl
        self.tracks: dict[str, Track] = {}
        for tr in sdl.tracks:
            if tr.track_type in (
                TrackType.TYPE_BOOL, TrackType.TYPE_INT,
                TrackType.TYPE_FLOAT, TrackType.TYPE_RESOURCE,
            ):
                self.tracks[tr.name] = tr

    @property
    def duration(self) -> int:
        last = 0
        for tr in self.tracks.values():
            if tr.keys:
                last = max(last, tr.keys[-1].frame)
        return last

    def sample(self, frame: float) -> dict:
        return {
            name: sample_track(tr, frame) for name, tr in self.tracks.items()
        }


class BoneAnimator:
    """joint<N>:<param> FLOAT tracks → bone palettes, on the host or on a
    device."""

    def __init__(self, timeline: Timeline, skeleton: Skeleton):
        self.skeleton = skeleton
        self.params: dict[tuple[int, str], tuple] = {}
        for name, tr in timeline.tracks.items():
            m = _JOINT_RE.match(name)
            if m and tr.track_type == TrackType.TYPE_FLOAT and tr.keys:
                jid = int(m.group(1))
                if jid < skeleton.num_joints:
                    self.params[(jid, m.group(2))] = track_arrays(tr)
        self._on: dict = {}      # device -> the tracks as tensors there

    def _tracks(self, device) -> dict:
        dev = torch.device(device)
        if dev not in self._on:
            self._on[dev] = _tracks_on(self.params, dev)
        return self._on[dev]

    def bone_mats(self, frame: float) -> np.ndarray:
        """Host path: palette (J, 4, 4) at ``frame``, the device path's
        ops on the CPU."""
        return self.bone_mats_device(frame, "cpu").numpy()

    def bone_mats_device(self, frame, device) -> torch.Tensor:
        """Tracks → deltas → FK → palette (J, 4, 4) f32 on ``device``
        (``frame`` a float or a 0-d tensor there): no host round trip."""
        j = self.skeleton.num_joints
        vals = {p: torch.zeros(j, dtype=torch.float32, device=device)
                for p in _PARAMS}
        for (jid, param), (f, v, lin) in self._tracks(device).items():
            vals[param] = torch.where(
                torch.arange(j, device=device) == jid,
                sample_device(f, v, lin, frame), vals[param])
        deltas = _euler_mats(*(vals[p] for p in _PARAMS))
        return self.skeleton.pose_device(deltas)


def _euler_mats(rx, ry, rz, tx, ty, tz) -> torch.Tensor:
    """Per-joint local delta T(t) · Rz · Ry · Rx as (J, 4, 4) f32 on the
    angles' device; cos and sin in f64, rounded once to f32."""
    def cs(a):
        a = a.to(torch.float64)
        return (torch.cos(a).to(torch.float32),
                torch.sin(a).to(torch.float32))

    (cx, sx), (cy, sy), (cz, sz) = cs(rx), cs(ry), cs(rz)
    zero = torch.zeros_like(rx)
    one = torch.ones_like(rx)
    rows = [
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx, tx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx, ty],
        [-sy, cy * sx, cy * cx, tz],
        [zero, zero, zero, one],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


class MaterialAnimator:
    """``material:<name>:<r|g|b|a>`` FLOAT tracks → per-frame (M, 4)
    color multipliers for ``DeviceScene.mat_color``.

    Completes the scheduler's parameter-animation story (parameters
    animated from rScheduler keys: bone mats, material params); swap the
    tensor into the scene with ``dataclasses.replace`` each frame (no
    re-upload).
    """

    _CH = {"r": 0, "g": 1, "b": 2, "a": 3}

    def __init__(self, timeline: Timeline, material_names: list[str]):
        self.num_materials = max(len(material_names), 1)
        self.params: dict[tuple[int, int], tuple] = {}
        slots = {n: i for i, n in enumerate(material_names)}
        for name, tr in timeline.tracks.items():
            if tr.track_type != TrackType.TYPE_FLOAT or not tr.keys:
                continue
            parts = name.split(":")
            if len(parts) == 3 and parts[0] == "material":
                slot = slots.get(parts[1])
                ch = self._CH.get(parts[2])
                if slot is not None and ch is not None:
                    self.params[(slot, ch)] = track_arrays(tr)
        self._on: dict = {}

    def mat_color(self, frame, device) -> torch.Tensor:
        """(M, 4) f32 multiplier at ``frame`` on ``device``."""
        dev = torch.device(device)
        if dev not in self._on:
            self._on[dev] = _tracks_on(self.params, dev)
        out = torch.ones((self.num_materials, 4), dtype=torch.float32,
                         device=dev)
        cells = torch.arange(self.num_materials * 4, device=dev).reshape(
            self.num_materials, 4)
        for (slot, ch), (f, v, lin) in self._on[dev].items():
            out = torch.where(cells == 4 * slot + ch,
                              sample_device(f, v, lin, frame), out)
        return out
