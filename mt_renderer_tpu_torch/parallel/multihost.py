"""Multi-process rendering over ``torch.distributed``.

The counterpart of ``mt_renderer_tpu/parallel/multihost.py``: the same
band split as ``tiles.render_frame_multichip``, one band per rank of a
process group in place of the slots of a row mesh. Every rank holds the
whole scene (its own upload) and renders its own rows, so no pixel
crosses processes during a frame; the only traffic is the rendezvous,
one small ``all_reduce`` of the overflow counts a frame (and one of the
column matrix under ``setup_shard``), and the optional full-frame gather
(``gather_full_frame``), which a viewer host wants and a per-host encoder
never pays.

Every exchange is an ``all_reduce`` (``tiles``), so the group's backend
may be gloo with CPU tensors, gloo with CUDA tensors (several ranks
sharing one card) or NCCL (one rank per card). Every rank must make the
same calls in the same order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tiles


def init(coordinator_address: str, num_processes: int, process_id: int,
         backend: str = "gloo"):
    """Join (or, as rank 0 of a TCP rendezvous, start) the rendering
    group: ``torch.distributed.init_process_group`` with ``backend``
    ("gloo", for CPU tensors or ranks that share a card, or "nccl") at
    ``coordinator_address``, a ``host:port`` or a ``tcp://`` or
    ``file://`` URL. → ``torch.distributed``."""
    import torch.distributed as dist

    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return dist


def global_row_mesh():
    """The group of every process (``torch.distributed``'s world), which
    ``render_frame_multihost`` splits into bands, rank-major: rank r
    renders band r."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("the rendering group is not formed: call "
                           "multihost.init first")
    return dist.group.WORLD


def host_scene(scene, device=None):
    """This rank's copy of ``scene``, on ``device`` (default: where it
    lies): each process holds the same asset bytes, as each GPU of the
    reference would hold its own upload."""
    return tiles.scene_to(scene, scene.device if device is None else device)


def render_frame_multihost(scene, view_proj, bone_mats=None, *,
                           width: int, height: int, **kw):
    """One band-split frame over every process:
    ``tiles.render_frame_multichip`` with the world group, every keyword
    of which it takes (``packed``, ``peel_layers``, ``mipmap``, ...). →
    (color, depth) as ``tiles.Band``s: this rank's rows only."""
    return tiles.render_frame_multichip(
        scene, view_proj, bone_mats, group=global_row_mesh(), width=width,
        height=height, **kw)


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """The bits of a 4-byte-per-pixel frame as int32: f32 depth, the
    int32 packed color, or the (.., 4) uint8 color."""
    if x.dtype == torch.uint8:
        return x.contiguous().view(torch.int32)
    if x.element_size() != 4:
        raise ValueError(f"a frame of {x.dtype} is not 4 bytes a pixel")
    return x.contiguous().view(torch.int32)


def gather_full_frame(frame: tiles.Band, height: int) -> np.ndarray:
    """The optional full-frame gather: every rank receives every band, as
    one ``all_reduce`` SUM of a zero-filled frame into which each rank
    wrote its rows as int32 bits (the bits cross unchanged). Every
    process must call it. → the (height, ...) frame on the host."""
    import torch.distributed as dist

    bits = _as_i32(frame.rows)
    full = bits.new_zeros((height, *bits.shape[1:]))
    n = min(bits.shape[0], max(0, height - frame.row0))
    full[frame.row0:frame.row0 + n] = bits[:n]
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=global_row_mesh())
    return full.view(frame.rows.dtype).reshape(
        height, *frame.rows.shape[1:]).cpu().numpy()


def local_rows(frame: tiles.Band, height: int) -> list:
    """This rank's rows of a band-split frame → [(row_start, np.ndarray)]
    (empty when its band lies past ``height``); rows past ``height`` are
    cropped."""
    if frame.row0 >= height:
        return []
    return [(frame.row0, frame.rows[:height - frame.row0].cpu().numpy())]
