"""Multi-device frames — the band split and the geometry split.

The counterpart of ``mt_renderer_tpu/parallel/tiles.py``. Two ways to
cut one frame over several devices:

* the **band split** (``render_frame_multichip``): the frame splits into
  horizontal bands of ceil(H / n) rows, one per slot. Every slot holds
  the whole scene (geometry and textures replicated), runs the vertex and
  setup stages for the whole frame (or, with ``setup_shard``, its own
  triangle range, the columns then gathered once), and rasterises and
  shades only its own band: K1 (and, peeled, K2) at the band's origin.
  Pixels never cross slots, so the bands compose with no merge;
* the **geometry split** (``render_frame_geomsplit``): each slot
  rasterises a chunk-aligned shard of the triangles over the full frame,
  and the per-pixel depth contest resolves across shards: MIN of depth,
  MAX of the winning global id among depth ties (the kernel's own
  later-triangle rule), SUM of the shaded planes each slot masked to the
  pixels it won (exactly one slot contributes a pixel).

A ``RowMesh`` is a tuple of ``torch.device``; a device may repeat.
``make_row_mesh(n)`` gives the first n cards; ``make_row_mesh(n,
device=d)`` gives n slots on ``d``, whose parts run one after another in
this process. With a ``torch.distributed`` process group in place of the
mesh (``parallel.multihost``), each rank renders its own band or shard on
its scene's device, and every exchange is an ``all_reduce``: MIN and MAX
as they are, and each gather a SUM over a zero-filled buffer whose f32
payload is viewed as int32, so the bits cross unchanged (a float sum
would turn -0.0 into +0.0). Gloo takes CUDA tensors for ``all_reduce``
(and ``broadcast``) only, so the same code runs on gloo with CPU tensors,
on gloo with CUDA tensors and on NCCL.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..render import device as dev
from ..render import raster as rs

_TRI_FIELDS = ("tri_texture", "tri_debug_id", "tri_flat",
                    "tri_material", "tri_valid", "tri_parts", "tri_vis")
_CORNER_FIELDS = ("positions", "uvs", "normals", "joints", "weights")


def make_row_mesh(n_devices: int | None = None, device=None) -> tuple:
    """A 1-D row mesh: a tuple of ``torch.device``, slot i rendering band
    (or shard) i. With no ``device``, the first ``n_devices`` CUDA cards
    (every card for None); it raises, naming the count, when fewer are
    visible. With ``device``, ``n_devices`` slots on that one device,
    rendered one after another."""
    if device is not None:
        if not n_devices or n_devices < 1:
            raise ValueError("slots on one device need n_devices >= 1")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return (device,) * n_devices
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or count
    if n < 1 or count < n:
        raise RuntimeError(f"a row mesh of {n or 'every'} CUDA devices "
                           f"needs {max(n, 1)}, {count} visible (make_row_"
                           f"mesh(n, device=d) puts n slots on one device)")
    return tuple(torch.device("cuda", i) for i in range(n))


def scene_to(scene: dev.DeviceScene, device) -> dev.DeviceScene:
    """``scene`` with every tensor on ``device`` (itself when already
    there): a slot's replica, or a rank's own copy."""
    device = torch.device(device)
    if scene.device == device:
        return scene
    return dataclasses.replace(scene, **{
        f: getattr(scene, f).to(device) for f in dev.TENSOR_FIELDS})


@dataclass
class Band:
    """This rank's part of a band-split frame: ``rows`` are the frame's
    rows ``row0`` .. ``row0 + len(rows)`` (none past its height)."""
    rows: torch.Tensor
    row0: int


class _Slots:
    """Where a split frame's parts run: every slot of a mesh in this
    process, or this rank alone of a process group. ``reduce`` combines
    one tensor per local part over all parts."""

    def __init__(self, scene, mesh, group):
        if (mesh is None) == (group is None):
            raise ValueError("pass either a mesh or a process group")
        self.group = group
        if group is None:
            self.n = len(mesh)
            self.ranks = list(range(self.n))
            self.devices = [torch.device(d) for d in mesh]
        else:
            import torch.distributed as dist

            self.n = dist.get_world_size(group)
            self.ranks = [dist.get_rank(group)]
            self.devices = [scene.device]
        if self.n < 1:
            raise ValueError("an empty mesh")
        self.scenes = [scene_to(scene, d) for d in self.devices]

    def reduce(self, parts, op: str):
        """``op`` ("sum", "min" or "max") over every part's tensor; the
        result lies on the first local device (in a process group, on
        every rank). An integer sum keeps its dtype."""
        if self.group is None:
            stacked = torch.stack([p.to(self.devices[0]) for p in parts])
            if op == "sum":
                return stacked.sum(0, dtype=stacked.dtype)
            return stacked.amin(0) if op == "min" else stacked.amax(0)
        import torch.distributed as dist

        out = parts[0].clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                                 "min": dist.ReduceOp.MIN,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return out

    def gather_sum(self, parts):
        """A bit-exact gather: each part is its slot's zero-filled f32
        buffer, summed as int32 views (one non-zero contribution per
        element) → the f32 buffer."""
        return self.reduce([p.contiguous().view(torch.int32) for p in parts],
                           "sum").view(torch.float32)


def _check_split_args(scene, backend: str, mipmap: bool, peel_layers: int,
                      setup_shard: bool, tap_tiles) -> None:
    if backend != "pallas":
        raise dev._by_decision(f"backend={backend!r}", dev._WHY_SCAN)
    dev._check_pool_path(scene, mipmap)
    if peel_layers and not 2 <= peel_layers <= rs.MAX_LAYERS:
        raise ValueError(f"peel_layers={peel_layers} out of range "
                         f"[2, {rs.MAX_LAYERS}]")
    if setup_shard and peel_layers:
        raise ValueError("setup_shard needs the non-peel path (the split "
                         "peel builds two column sets)")
    if isinstance(tap_tiles, tuple) and not (peel_layers or mipmap):
        raise ValueError("tuple tap_tiles is the split peel's (opaque, "
                         "translucent) cap pair")


def _scene_tri_shard(scene: dev.DeviceScene, lo: int, size: int,
                     tp: int) -> dev.DeviceScene:
    """The triangle range [lo, lo + size) of a scene, the unit of the
    sharded setup: a slice of every per-triangle tensor, of ``cols_const``
    along its triangle axis (dim 1: the port's column-major (10, Tp)), and
    of the corner-planar vertex tensors as three corner blocks, so that
    ``setup_packed_cols`` reads the shard as a scene of ``size``
    triangles. The last shard's range is clamped into the scene; its
    rows that alias an earlier shard's triangles are left out of
    ``tri_vis``, so their columns bake REJECT like padding, and the
    gathered matrix holds each real triangle live once, in global order
    (the later-triangle tie rule is unchanged)."""
    start = min(max(lo, 0), max(tp - size, 0))
    rid = start + torch.arange(size, device=scene.device)
    fields = {f: getattr(scene, f).narrow(0, start, size)
              for f in _TRI_FIELDS}
    fields.update({f: torch.cat([getattr(scene, f).narrow(0, c * tp + start,
                                                          size)
                                 for c in range(3)])
                   for f in _CORNER_FIELDS})
    fields["cols_const"] = scene.cols_const.narrow(1, start, size)
    fields["tri_vis"] = fields["tri_vis"] & (rid >= lo) & (rid < tp)
    return dataclasses.replace(scene, **fields)


def _sharded_setup(slots: _Slots, view_proj, bone_mats, width: int,
                   height: int, lighting: bool) -> list:
    """``setup_shard``: each slot runs the vertex and setup stages on its
    triangle range; one gather assembles the full column matrix and the
    group bboxes on every slot → one (cols, bbox) per local slot."""
    tp = slots.scenes[0].tri_valid.shape[0]
    shard_t = cdiv_mult(tp, slots.n, dev.TRI_PAD)
    flats = []
    for scene, r in zip(slots.scenes, slots.ranks):
        shard = _scene_tri_shard(scene, r * shard_t, shard_t, tp)
        cols, bbox = dev.setup_packed_cols(
            shard, dev.vertex_stage(shard, view_proj, bone_mats), width,
            height, bone_mats=bone_mats, lighting=lighting)
        flats.append((cols, bbox))
    n_rows = flats[0][0].shape[0]
    total = shard_t * slots.n
    if slots.group is None:
        cols = torch.cat([c.to(slots.devices[0]) for c, _ in flats], 1)
        bbox = tuple(torch.cat([b[k].to(slots.devices[0]) for _, b in flats])
                     for k in range(5))
    else:
        # one buffer: the (rows, total) matrix, then the five bbox rows
        (cols_s, bbox_s), = flats
        r = slots.ranks[0]
        g, gs = total // rs.KG, shard_t // rs.KG
        buf = cols_s.new_zeros(n_rows * total + 5 * g)
        buf[:n_rows * total].view(n_rows, total)[
            :, r * shard_t:(r + 1) * shard_t] = cols_s
        buf[n_rows * total:].view(5, g)[:, r * gs:(r + 1) * gs] = \
            torch.stack(bbox_s)
        buf = slots.gather_sum([buf])
        cols = buf[:n_rows * total].view(n_rows, total)
        bbox = tuple(buf[n_rows * total:].view(5, g))
    return [(cols.to(d), tuple(b.to(d) for b in bbox))
            for d in slots.devices]


def _render_band(scene: dev.DeviceScene, setup, *, y0: int, band_h: int,
                 pw: int, pb: int, width: int, maxc, tap_tiles, clear_color,
                 mipmap: bool, lighting: bool, packed: bool,
                 peel_layers: int):
    """One band: rows [y0, y0 + band_h) of the frame, rendered over its
    tile-aligned ``pw`` x ``pb`` grid from the full frame's setup →
    (packed color (band_h, width) i32, depth (band_h, width) f32,
    (n_bins, n_tap or None) device counts)."""
    light = dev._light_unit() if lighting else None
    if peel_layers:
        dst, z0, n_over = dev._split_peel_flat(
            scene, *setup, pw=pw, ph=pb, layers=peel_layers,
            maxc=maxc or rs.MAXC_DEFAULT, tap_tiles=tap_tiles,
            clear_color=clear_color, y0=y0, mipmap=mipmap, light=light)
        colort = dev.pack_u32_channels(dst)
    else:
        # the unpacked bilinear band shades every tap row, as the
        # reference's does (render_frame's rule); the trilinear band
        # takes a scalar cap only
        dense = not packed and not mipmap
        taps = (None if dense or isinstance(tap_tiles, tuple)
                else tap_tiles)
        colort, z0, n_over = dev._single_layer_flat(
            scene, *setup, y0=y0, pw=pw, ph=pb, maxc=maxc, tap_tiles=taps,
            clear_color=clear_color, mipmap=mipmap, light=light)
        if dense:
            n_over = (n_over[0], None)
    color = rs.unflatten_tiles(colort, pb, pw)[:band_h, :width]
    depth = rs.unflatten_tiles(z0, pb, pw)[:band_h, :width]
    return color, depth, n_over


def _sum_counts(slots: _Slots, counts) -> tuple:
    """The parts' (bins, taps or None) counts summed over every part (one
    reduction of the stacked pair; a dense shade's None stays None)."""
    dense = counts[0][1] is None
    total = slots.reduce([torch.stack([b, b if dense else t]).to(torch.int32)
                          for b, t in counts], "sum")
    return total[0], None if dense else total[1]


def render_frame_multichip(scene: dev.DeviceScene, view_proj, bone_mats=None,
                           *, mesh: tuple | None = None, group=None,
                           width: int = 512, height: int = 512,
                           clear_color: tuple = (255, 255, 255, 255),
                           backend: str = "pallas", maxc: int | None = None,
                           mipmap: bool = False, lighting: bool = False,
                           check_overflow: bool = True, packed: bool = False,
                           tap_tiles=None, peel_layers: int = 0,
                           setup_shard: bool = False):
    """Render one frame split into screen bands → (color, (H, W) f32
    depth), the same bits as ``device.render_frame`` (or, with
    ``peel_layers``, ``render_frame_peeled(peel_mode="split")``).

    ``mesh`` (``make_row_mesh``) renders its n bands in this process and
    assembles the full frame on slot 0's device. ``group`` (a
    ``torch.distributed`` process group) renders this rank's band of
    ``group``'s size on the scene's device and returns (color, depth) as
    ``Band``s (``multihost.local_rows``, ``gather_full_frame``).

    Bands are ceil(H / n) rows, each padded to whole tiles, rendered at
    origin (0, band × band rows) and cropped. Per band: the packed tap
    with compacted taps (``tap_tiles`` from ``device.auto_tap_tiles(
    bands=n)``); the unpacked tap, dense; the trilinear shade with
    ``mipmap`` (any pool that renders mipmapped); the split peel with
    ``peel_layers`` L, ``tap_tiles`` then one cap or the (opaque,
    translucent) pair from ``device.measure_live_tap_tiles(mode="split",
    bands=n)``. ``packed``: color is (H, W) int32 holding RGBA8 bits;
    otherwise the (H, W, 4) uint8 view of the same plane.

    ``setup_shard`` (not with ``peel_layers``): each slot runs the vertex
    and setup stages on its triangle range only, and one gather
    assembles the column matrix; the frame keeps its bits.

    The bands' bins and tap overflow counts are summed and queued
    (``check_overflow``), each against one band's cap."""
    _check_split_args(scene, backend, mipmap, peel_layers, setup_shard,
                      tap_tiles)
    slots = _Slots(scene, mesh, group)
    band_h, pb = dev.band_rows(height, slots.n)
    pw, _ = dev._padded(width, height)
    if setup_shard:
        setups = _sharded_setup(slots, view_proj, bone_mats, width, height,
                                lighting)
    else:
        setups = [dev.setup_packed_cols(
            s, dev.vertex_stage(s, view_proj, bone_mats), width, height,
            opacity_split=bool(peel_layers), bone_mats=bone_mats,
            lighting=lighting) for s in slots.scenes]
    outs = [_render_band(s, setup, y0=r * band_h, band_h=band_h, pw=pw,
                         pb=pb, width=width, maxc=maxc, tap_tiles=tap_tiles,
                         clear_color=clear_color, mipmap=mipmap,
                         lighting=lighting, packed=packed,
                         peel_layers=peel_layers)
            for s, setup, r in zip(slots.scenes, setups, slots.ranks)]
    if check_overflow:
        dev._queue_frame_overflow(_sum_counts(slots, [o[2] for o in outs]),
                                  maxc, tap_tiles, width, pb)

    def view(color):
        return color if packed else color.view(torch.uint8).reshape(
            *color.shape, 4)

    if group is None:
        d0 = slots.devices[0]
        color = torch.cat([o[0].to(d0) for o in outs])[:height]
        depth = torch.cat([o[1].to(d0) for o in outs])[:height]
        return view(color.contiguous()), depth.contiguous()
    row0 = slots.ranks[0] * band_h
    keep = max(0, min(band_h, height - row0))
    color, depth = outs[0][0][:keep], outs[0][1][:keep]
    return Band(view(color.contiguous()), row0), Band(depth.contiguous(),
                                                      row0)


def cdiv_mult(total: int, n: int, quantum: int) -> int:
    """Smallest per-shard size covering ``total`` over ``n`` shards in
    multiples of ``quantum``."""
    per = -(-total // n)
    return -(-per // quantum) * quantum


def _geom_shard(scene: dev.DeviceScene, view_proj, bone_mats, *, r: int,
                n: int, width: int, height: int, maxc, tap_tiles,
                mipmap: bool, lighting: bool):
    """Shard ``r`` of ``n``: K1 over a chunk-aligned triangle range of
    the full frame's setup, then its shade → (z (n_tiles, P) f32 with
    +inf where it covers nothing, global winner ids or -1, src channels
    [r, g, b, a], (n_bins, n_tap) device counts)."""
    pw, ph = dev._padded(width, height)
    light = dev._light_unit() if lighting else None
    cols, bbox = dev.setup_packed_cols(
        scene, dev.vertex_stage(scene, view_proj, bone_mats), width, height,
        bone_mats=bone_mats, lighting=lighting)
    tp = cols.shape[1]
    shard_t = cdiv_mult(tp, n, rs.CT)
    pad_t = shard_t * n - tp
    if pad_t:
        # always-outside padding (zero edge coefficients fail e > 0) that
        # is never binned (empty group bboxes): no triangle is in two
        # shards, where it would tie with itself and count twice
        big = 1e30
        cols = torch.cat([cols, cols.new_zeros(cols.shape[0], pad_t)], 1)
        bbox = tuple(torch.cat([b, b.new_full((pad_t // rs.KG,), v)])
                     for b, v in zip(bbox, (big, -big, big, -big, big)))
    base = r * shard_t
    cols_s = cols[:, base:base + shard_t]
    bbox_s = tuple(b[base // rs.KG:(base + shard_t) // rs.KG] for b in bbox)
    lists, glists, counts, n_bins = rs.prebin(
        cols_s, bbox_s, 0, 0, width=pw, height=ph,
        maxc=maxc or rs.MAXC_DEFAULT)
    kw = dict(width=pw, height=ph, w_eps=dev.W_EPS, light=light)
    if mipmap:
        zb, ib, mattrs = rs.raster_fwd(cols_s, lists, glists, counts, (0, 0),
                                       mode="mtap", **kw)
        src, _, n_tap = dev.shade_mip_tap_flat_channels(
            scene, mattrs, ib, tap_tiles=tap_tiles)
    else:
        # each shard covers a subset of the full frame's pixels, so the
        # single frame's cap bounds every shard
        zb, ib, tattrs, tapidx = rs.raster_fwd(cols_s, lists, glists,
                                               counts, (0, 0), **kw)
        src, _, n_tap = dev.shade_tap_flat_channels(
            scene, tattrs, tapidx, ib, tap_tiles=tap_tiles)
    ids = torch.where(ib[:, 0] >= 0, ib[:, 0] + base, -1)
    z = torch.where(ids >= 0, zb[:, 0], float("inf"))
    return z, ids, src, (n_bins, n_tap)


def render_frame_geomsplit(scene: dev.DeviceScene, view_proj, bone_mats=None,
                           *, mesh: tuple | None = None, group=None,
                           width: int = 512, height: int = 512,
                           clear_color: tuple = (255, 255, 255, 255),
                           backend: str = "pallas", maxc: int | None = None,
                           mipmap: bool = False, lighting: bool = False,
                           check_overflow: bool = True, packed: bool = False,
                           tap_tiles: int | None = None):
    """Render one frame split by geometry → (color, (H, W) f32 depth),
    the same bits as ``device.render_frame``; the full frame on slot 0's
    device (``mesh``) or on every rank (``group``).

    Each slot rasterises a chunk-aligned shard of the triangles over the
    whole frame (K1, the tap or with ``mipmap`` the mtap epilogue) and
    shades it; the last shard is padded with always-outside columns. The
    merge: MIN of depth, MAX of the global winner id among the slots tied
    at that depth, and a SUM of the shaded planes each slot masked to the
    pixels it won, as int32 views. ``tap_tiles`` caps each shard's
    compacted taps (``device.auto_tap_tiles`` bounds every shard: a
    shard covers a subset of the frame). ``packed`` and the overflow
    queue as in ``render_frame_multichip``."""
    _check_split_args(scene, backend, mipmap, 0, False, tap_tiles)
    slots = _Slots(scene, mesh, group)
    pw, ph = dev._padded(width, height)
    parts = [_geom_shard(s, view_proj, bone_mats, r=r, n=slots.n, width=width,
                         height=height, maxc=maxc, tap_tiles=tap_tiles,
                         mipmap=mipmap, lighting=lighting)
             for s, r in zip(slots.scenes, slots.ranks)]
    d0 = slots.devices[0]
    zs = [p[0].to(d0) for p in parts]
    ids = [p[1].to(d0) for p in parts]
    zmin = slots.reduce(zs, "min")
    tied = [(z == zmin) & (i >= 0) for z, i in zip(zs, ids)]
    win = slots.reduce([torch.where(t, i, -1) for t, i in zip(tied, ids)],
                       "max")
    mine = [t & (i == win) for t, i in zip(tied, ids)]
    src = slots.gather_sum([torch.stack([torch.where(m, c.to(d0), 0.0)
                                         for c in p[2]])
                            for m, p in zip(mine, parts)])
    covered = win >= 0
    if check_overflow:
        dev._queue_frame_overflow(_sum_counts(slots, [p[3] for p in parts]),
                                  maxc, tap_tiles, width, height)
    colort = dev._blend_pack_u32(list(src), covered, clear_color)
    color = rs.unflatten_tiles(colort, ph, pw)[:height, :width].contiguous()
    depth = rs.unflatten_tiles(torch.where(covered, zmin, 1.0), ph,
                               pw)[:height, :width].contiguous()
    if not packed:
        color = color.view(torch.uint8).reshape(height, width, 4)
    return color, depth
