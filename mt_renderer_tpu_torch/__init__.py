"""mt_renderer_tpu_torch — the renderer's device path in PyTorch and CUDA.

The counterpart of ``mt_renderer_tpu`` for one NVIDIA Hopper GPU: the
device stages (``render.device``), the binned tile rasters and their
hand-written CUDA kernels (``render.raster``; ``csrc/raster_fwd.cu``,
single layer, and ``csrc/raster_fwd_ml.cu``, multi-layer for
order-independent transparency), the frame loop (``render.engine``) and
the device animation (``scene.skeleton``, ``scene.animation``).

It imports neither ``jax`` nor anything of ``mt_renderer_tpu``: the
machine that runs it on the card has no jax, and the port stands alone.
The host layers it needs (asset formats, the DTI registry, scene
assembly, the archive world, the camera, the NumPy oracle) are its own
copies of the JAX package's, under the same names.
"""

import torch

__version__ = "0.1.0"


def setup_runtime() -> None:
    """Keep fp32 geometry at full precision. A TF32 product keeps ~10
    mantissa bits, far too few for edge functions at 1080p: coverage
    would collapse the way bf16 matmuls collapsed it on the TPU. The port
    uses no matmul on its geometry today; this pins the rule for any
    that is added."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


setup_runtime()
