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
* On a CUDA device ``RenderArtifact`` replays the binned program as
  one CUDA graph (``_Graph``), where the reference's XLA executable is
  one compiled program: captured on the second call with the same scene
  leaves (the first runs eagerly and warms up), replayed from then on,
  so a request costs the host a few copies and one launch instead of
  the program's hundreds. On the CPU, and for the scan program (its
  unrolled loop copies host constants to the device, which a capture
  refuses), every call runs the program.
"""

from __future__ import annotations

import io
import json

import numpy as np
import torch

from .render import device, raster
from .utils.profiling import count, recording, span

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
    meta = dict(device=str(dev), width=width, height=height, backend=backend)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_META: json.dumps(meta)})
    return buf.getvalue()


def _call_key(leaves, view_proj, bone_mats) -> tuple:
    """What a captured graph is bound to: each leaf's address, shape,
    dtype and strides, and the view's and the palette's shapes."""
    shapes = tuple(tuple(x.shape) if isinstance(x, torch.Tensor)
                   else np.shape(x) for x in (view_proj, bone_mats))
    return tuple((x.data_ptr(), tuple(x.shape), x.dtype, x.stride())
                 for x in leaves) + shapes


# the hand kernels a step can launch, whose ``launches`` counters a
# replay advances as the eager call would
_COUNTED = ((raster, "raster_fwd"), (device, "bc7_trilinear"))


class _Graph:
    """The loaded step captured as one CUDA graph on one set of scene
    leaves (``key``): input buffers for the view and the palette, the
    outputs it writes, and what the capture counted (the kernels'
    ``launches`` and ``profiling.count``'s counters), which every replay
    counts again. Capturing launches nothing; the first replay renders
    the capture's inputs."""

    def __init__(self, key, step, leaves, vp, bones):
        self.key = key
        self.vp, self.bones = vp.clone(), bones.clone()
        fns = [getattr(mod, name) for mod, name in _COUNTED]
        before = [f.launches for f in fns]
        self.graph = torch.cuda.CUDAGraph()
        with recording() as self.counts:
            with torch.cuda.graph(self.graph):
                self.out = step(leaves, self.vp, self.bones)
        self.launches = [(f, f.launches - n) for f, n in zip(fns, before)]
        for f, n in zip(fns, before):
            f.launches = n

    def load(self, view_proj, bone_mats) -> None:
        """Copy the request's view and palette (the capture's shapes)
        into the input buffers, one copy each."""
        for buf, x in ((self.vp, view_proj), (self.bones, bone_mats)):
            buf.copy_(x if isinstance(x, torch.Tensor)
                      else torch.as_tensor(np.asarray(x, np.float32)))

    def replay(self) -> list:
        """Render the loaded inputs → the outputs, cloned: the next
        replay overwrites the graph's own."""
        self.graph.replay()
        for f, n in self.launches:
            f.launches += n
        for name, n in self.counts.items():
            count(name, n)
        count("serve.replays", 1)
        return [x.clone() for x in self.out]


class RenderArtifact:
    """A deserialised render step ready to serve."""

    def __init__(self, blob: bytes):
        extra = {_META: ""}
        self._program = torch.export.load(io.BytesIO(blob),
                                          extra_files=extra)
        self.meta = json.loads(extra[_META])
        self.device = torch.device(self.meta["device"])
        self._step = self._program.module()
        # the scan program copies host constants to the device, which a
        # capture refuses: it stays eager, as does an artifact on the CPU
        self._graphed = (self.device.type == "cuda"
                         and self.meta.get("backend") == "pallas")
        self._graph = None      # the step captured
        self._eager_key = None  # ``_call_key`` of the last eager call

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

        On a CUDA device the binned program (``backend="pallas"``) runs
        as one CUDA graph keyed by the leaves' identity (``_call_key``):
        a call on the leaves of the graph replays it; a call on new
        leaves runs the program eagerly, and the next call on the same
        leaves captures it (``_Graph``, replacing the graph of other
        leaves) and replays. A replay's
        outputs are its own copies, so a frame the caller holds never
        changes.

        Under a profiler the request is the span ``serve.request``, around
        ``serve.inputs``, ``serve.step`` (the program's call or the
        graph's replay; the graph itself holds no span; ``serve.capture``
        inside it where the call captures) and ``serve.queue``; the
        counters ``serve.replays`` and ``serve.captures`` count the
        requests that replayed and the captures."""
        with span("serve.request"):
            with span("serve.inputs"):
                leaves = self._leaves(scene)
                key = (_call_key(leaves, view_proj, bone_mats)
                       if self._graphed else None)
                graph = self._graph
                if graph is not None and graph.key == key:
                    graph.load(view_proj, bone_mats)
                else:
                    graph = None
                    vp = device._f32(view_proj, self.device)
                    bones = device._f32(bone_mats, self.device)
            with span("serve.step"):
                if graph is None and key is not None \
                        and key == self._eager_key:
                    self._graph = None      # its memory goes first
                    with span("serve.capture"):
                        graph = self._graph = _Graph(key, self._step,
                                                     leaves, vp, bones)
                    count("serve.captures", 1)
                if graph is not None:
                    out = graph.replay()
                else:
                    out = self._step(leaves, vp, bones)
                    self._eager_key = key
                color, depth, n_over, n_over_tap = out
            with span("serve.queue"):
                device._queue_frame_overflow((n_over, n_over_tap), None,
                                             None, self.meta["width"],
                                             self.meta["height"])
            return color, depth


def load_render(blob: bytes) -> RenderArtifact:
    return RenderArtifact(blob)
