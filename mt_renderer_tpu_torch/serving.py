"""Serving: ahead-of-time export of the render step.

The counterpart of ``mt_renderer_tpu/serving.py``. A serving host should
not need the scene code or the asset toolchain: the whole frame (vertex
→ setup → bin → raster → shade) exports to one ``torch.export`` program
keyed by the scene's tensor shapes, serialised with
``torch.export.save``. A serving process loads the program and calls it
with (scene tensors, view_proj, bone_mats).

The program is specialised to (resolution, texel pool, triangle count)
as the reference's artifact is. Where it differs from the reference's:

* K1 stands in the graph as the custom op ``mtr::raster_fwd_tap`` (or
  ``_mtap``, mipmapped; ``render.raster.K1_OPS``). The serving host
  needs this package, which registers the op and builds its kernel; the
  reference's artifact needs only JAX, since Mosaic embeds its kernel.
* The program returns the frame's two overflow counts beside the frame,
  and ``RenderArtifact`` queues them (``raster.queue_overflow_check``),
  so a served frame's overflow warns as an eager frame's does; the
  reference's artifact drops them (its queue is a no-op under tracing).
* The graph holds its device. ``platforms`` may only name the scene's
  own device type, and an artifact runs tensors on that device only.
* ``backend="scan"`` exports the scan frame with its chunk loop unrolled
  (``torch.export`` traces Python loops out): the program holds one
  step's ops per ``DEFAULT_CHUNK`` triangles, so its size grows with the
  triangle count, where the reference's ``lax.scan`` stays one loop.
  Its overflow counts are zeros: the scan backend has no caps.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from .render import device
from .utils.profiling import span

_META = "mtr_render.json"


def scene_leaves(scene: device.DeviceScene) -> list:
    """The serving ABI: the scene's tensors as a flat list in
    ``device.TENSOR_FIELDS`` order. The statics (``STATIC_FIELDS``) are
    baked into the artifact."""
    return [getattr(scene, f) for f in device.TENSOR_FIELDS]


class _RenderStep(torch.nn.Module):
    """``render_frame`` on flat leaves, returning the overflow counts
    beside the frame instead of queueing them."""

    def __init__(self, statics: dict, width: int, height: int,
                 mipmap: bool, backend: str):
        super().__init__()
        self.statics = statics
        self.width = width
        self.height = height
        self.mipmap = mipmap
        self.backend = backend

    def forward(self, leaves, view_proj, bone_mats):
        scene = device.DeviceScene(**dict(zip(device.TENSOR_FIELDS, leaves)),
                                   **self.statics)
        if self.backend == "scan":
            color, depth = device.render_frame(
                scene, view_proj, bone_mats, width=self.width,
                height=self.height, backend="scan", mipmap=self.mipmap)
            zero = torch.zeros((), dtype=torch.int32, device=depth.device)
            return color, depth, zero, zero
        color, depth, (n_over, n_over_tap) = device._render_frame_core(
            scene, view_proj, bone_mats, width=self.width,
            height=self.height, clear_color=(255, 255, 255, 255),
            maxc=None, tap_tiles=None, mipmap=self.mipmap)
        color = color.view(torch.uint8).reshape(self.height, self.width, 4)
        return color, depth, n_over, n_over_tap


def export_render(scene: device.DeviceScene, *, width: int, height: int,
                  backend: str = "pallas", mipmap: bool = False,
                  platforms: list[str] | None = None) -> bytes:
    """Serialize the render step for this scene's shapes → the artifact's
    bytes (a ``torch.export`` program and its calling convention).

    The program is traced on the scene's device and holds it:
    ``platforms`` may be None or name that device's type only
    (``["cuda"]`` for a card scene, ``["cpu"]`` for a CPU one); the
    reference's cross-export to another platform raises ``ValueError``.
    ``backend="scan"`` exports the scan frame (any pool, mipmapped or
    not), its chunk loop unrolled."""
    if backend not in ("pallas", "scan"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = scene.device
    if platforms is not None and list(platforms) != [dev.type]:
        raise ValueError(
            f"platforms={platforms!r}: the program holds the scene's device "
            f"({dev}); export on that device with platforms=None or "
            f"[{dev.type!r}]")
    if backend == "pallas":
        device._check_pool_path(scene, mipmap)
    statics = {f: getattr(scene, f) for f in device.STATIC_FIELDS}
    step = _RenderStep(statics, width, height, mipmap, backend)
    args = (scene_leaves(scene),
            torch.zeros((4, 4), dtype=torch.float32, device=dev),
            torch.zeros((scene.num_joints, 4, 4), dtype=torch.float32,
                        device=dev))
    program = torch.export.export(step, args)
    program.example_inputs = None     # the scene itself stays out of it
    meta = dict(device=str(dev), width=width, height=height)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


class RenderArtifact:
    """A deserialised render step ready to serve."""

    def __init__(self, blob: bytes):
        extra = {_META: ""}
        self._program = torch.export.load(io.BytesIO(blob),
                                          extra_files=extra)
        self.meta = json.loads(extra[_META])
        self.device = torch.device(self.meta["device"])
        self._step = self._program.module()

    def _leaves(self, scene) -> list:
        """The scene's leaves on the artifact's device: NumPy arrays are
        copied there; a tensor on another device raises."""
        leaves = (scene_leaves(scene)
                  if isinstance(scene, device.DeviceScene) else list(scene))
        if len(leaves) != len(device.TENSOR_FIELDS):
            raise ValueError(f"{len(leaves)} leaves, the artifact takes "
                             f"{len(device.TENSOR_FIELDS)}")
        out = []
        for name, x in zip(device.TENSOR_FIELDS, leaves):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x), device=self.device)
            elif x.device != self.device:
                raise ValueError(f"leaf {name} is on {x.device}, the "
                                 f"artifact runs on {self.device}")
            out.append(x)
        return out

    def __call__(self, scene, view_proj, bone_mats):
        """Render one frame → (color (H, W, 4) u8, depth (H, W) f32) on
        the artifact's device. ``scene`` is a ``DeviceScene`` or its
        ``scene_leaves``; ``view_proj`` (4, 4) and ``bone_mats`` (J, 4,
        4), NumPy or tensors, go to the artifact's device. The frame's
        overflow counts go to the deferred queue with the reference's
        default caps (``MAXC_DEFAULT`` chunks, every tap row).

        Under a profiler the request is the span ``serve.request``, around
        ``serve.inputs``, ``serve.step`` (the loaded program's call: the
        host issuing every launch; the graph itself holds no span) and
        ``serve.queue``."""
        with span("serve.request"):
            with span("serve.inputs"):
                leaves = self._leaves(scene)
                vp = device._f32(view_proj, self.device)
                bones = device._f32(bone_mats, self.device)
            with span("serve.step"):
                color, depth, n_over, n_over_tap = self._step(leaves, vp,
                                                              bones)
            with span("serve.queue"):
                device._queue_frame_overflow((n_over, n_over_tap), None,
                                             None, self.meta["width"],
                                             self.meta["height"])
            return color, depth


def load_render(blob: bytes) -> RenderArtifact:
    return RenderArtifact(blob)
