"""K2's per-warp cull: its plain twin against the multi-layer raster.

K2 (``csrc/raster_fwd_ml.cu``) runs K1's CTA layout and culls every
staged 32-triangle group per warp before any pixel test, with K1's exact
corner test (``raster.warp_cull_reference``, held exact per edge by
``tests/test_torch_k1_cull.py``). The lists stay those of the full
evaluation only if the cull never drops a (triangle, warp) pair with a
candidate that passes the per-pixel tests. These tests hold that, exactly
(no tolerance):

- every id ``raster_fwd_ml_reference`` keeps in any layer survives the
  twin at its pixel's warp, on the stack, glass, adversarial and
  heavy-tile scenes, for L in {2, 4, 8} (2 on the heavy tile), full and
  nocull, with and without zhi (seeded horizons hold -0.0, negative,
  +inf and NaN pixels);
- the kernel's loop, modelled in torch (pairs in list order, the cull,
  per-candidate insertion in ascending k, the running limits as the
  kernel keeps them), gives the reference's lists bit for bit;
- K2's library is built from the header whose layout ``raster.LAYOUT``
  copies.

The kernel itself is held against ``raster_fwd_ml_reference`` on the
card (``tests/test_torch_gpu.py``, on these same scenes). No jax here.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mt_renderer_tpu_torch.render import device as td
from mt_renderer_tpu_torch.render import raster as tr
from mt_renderer_tpu_torch.tools import raster_roofline
from test_torch_gpu import _glass, stack_batch, stack_view_proj
from test_torch_k1_cull import W, H, adversarial_cols, heavy_tile_case
from torch_threads import one_thread  # noqa: F401

SCENES = ["stack", "glass", "adversarial", "heavy"]

VARIANTS = ["full", "full_zhi", "nocull", "nocull_zhi"]
INF = float("inf")


def seeded_horizon(n_tiles: int, lo: float = 0.0, hi: float = 1.0,
                   seed: int = 5):
    """A per-pixel depth horizon (n_tiles, 1, P) f32 in [lo, hi), with
    +inf, -0.0, 0.0, negative and NaN pixels mixed in."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(lo, hi, (n_tiles, 1, tr.P)).astype(np.float32)
    pick = rng.random(z.shape)
    z[pick < 0.15] = np.inf
    z[(pick >= 0.15) & (pick < 0.17)] = -0.0
    z[(pick >= 0.17) & (pick < 0.18)] = 0.0
    z[(pick >= 0.18) & (pick < 0.2)] = -0.5
    z[(pick >= 0.2) & (pick < 0.21)] = np.nan
    return torch.from_numpy(z)


def _split_scene(batch, vp, bones, width, height):
    """A scene's setup with its opacity split → (all, opaque,
    translucent) raster arguments, binned at ``auto_maxc``."""
    scene = td.upload(batch, device="cpu")
    clip = td.vertex_stage(scene, vp, bones)
    maxc = td.auto_maxc(batch, vp, bones, width=width, height=height)
    sets = [td.setup_packed_cols(scene, clip, width, height),
            *td.setup_packed_cols(scene, clip, width, height,
                                  opacity_split=True)]
    return [(cols, *tr.prebin(cols, bbox, 0, 0, width=width, height=height,
                              maxc=maxc)[:3], (0, 0))
            for cols, bbox in sets]


@functools.lru_cache(maxsize=None)
def k2_case(scene: str, variant: str):
    """K2's raster arguments and keywords (but ``layers``) on a seeded
    scene. "stack" and "glass" bin the scene's every triangle, except
    for nocull with zhi, which bins the translucent set behind K1's
    opaque z-buffer, as the split peel does; their full variant with zhi
    takes that z-buffer too. "adversarial" (with every other triangle
    made translucent) and "heavy" take a ``seeded_horizon`` over their
    depths as zhi."""
    if scene in ("stack", "glass"):
        if scene == "stack":
            batch, vp, bones = stack_batch(), stack_view_proj(W, H), None
        else:
            batch, vp, bones = _glass(instances=16)
        every, opaque, translucent = _split_scene(batch, vp, bones, W, H)
        zo, io = tr.raster_fwd_reference(*opaque, width=W, height=H,
                                         w_eps=td.W_EPS)[:2]
        horizon = torch.where(io >= 0, zo, INF)
        args = translucent if variant == "nocull_zhi" else every
        kw = dict(width=W, height=H)
    else:
        if scene == "adversarial":                 # 256x64: 8 tiles
            cols, *rest = adversarial_cols(height=H // 2)
            cols = cols.clone()
            cols[tr.TEX_ROW, 1::2] += 0.5        # translucent
            args, kw = (cols, *rest, (0, 0)), dict(width=W, height=H // 2)
            horizon = seeded_horizon(args[3].shape[0])
        else:                       # its depths lie in [0.9997, 1.0008]
            args, kw = heavy_tile_case()
            horizon = seeded_horizon(args[3].shape[0], 0.9997, 1.0005)
    kw.update(w_eps=td.W_EPS, opaque_cull=variant.startswith("full"),
              zhi=horizon if variant.endswith("zhi") else None)
    return args, kw


def kept_outside(live, lists, il) -> int:
    """Ids kept in any layer whose (triangle, warp) pair ``live`` (the
    twins' shape) rejects at the pixel's warp."""
    wp = torch.arange(tr.P)
    row, col = wp // tr.TILE_W, wp % tr.TILE_W
    warp = ((col // tr.PART_W) * (tr.WARPS // tr.PARTS)
            + (row // tr.WARP_H) * (tr.PART_W // tr.WARP_W)
            + (col % tr.PART_W) // tr.WARP_W)
    bad = 0
    for layer in range(il.shape[1]):
        ids = il[:, layer]
        win = ids.clamp(min=0).long()
        slot = (lists[:, :, None] == (win // tr.CT)[:, None, :]).int() \
            .argmax(1)
        ok = live[torch.arange(ids.shape[0])[:, None], slot,
                  (win % tr.CT) // tr.KG, warp[None, :], win % tr.KG]
        bad += int(((ids >= 0) & ~ok).sum())
    return bad


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scene", SCENES)
def test_kept_ids_survive_the_culls(scene, variant):
    """Every id the plain K2 keeps in any layer, for L = 2, 4, 8 (2 alone
    on the heavy tile, whose long lists make the plain K2 slow), lies in
    a (triangle, warp) pair that survives the cull; and the cull does cut
    the binned work."""
    args, kw = k2_case(scene, variant)
    live = tr.warp_cull_reference(*args, width=kw["width"],
                                  height=kw["height"])
    n_kept = 0
    for layers in (2,) if scene == "heavy" else (2, 4, 8):
        il = tr.raster_fwd_ml_reference(*args, layers=layers, **kw)[1]
        n_kept += int((il >= 0).sum())
        assert kept_outside(live, args[1], il) == 0
    assert n_kept > 0
    pairs = int(raster_roofline.tile_pairs(*args[1:4]).sum())
    assert int(live.sum()) < 0.8 * pairs * tr.WARPS * tr.KG


def kernel_model(cols, lists, glists, counts, origin, *, width, height,
                 layers, opaque_cull, zhi, w_eps=None):
    """K2's loop in torch, per warp (``warp_pixel_centers``' order): each
    tile's live (chunk, group) pairs in list order; per pair, the edge
    cull; then the survivors in ascending k, each candidate that passes
    the per-pixel tests inserted on its own into the (z asc, id desc)
    list, and the pixel's limits updated as the kernel keeps them: zcap =
    min(zhi, opaque z), set to z by an opaque candidate, and zlim =
    fminf(deepest z, zcap). Asserts that no culled pair holds a
    candidate. → (zl, il) tile-major, as ``raster_fwd_ml_reference``
    returns them."""
    n_tiles = counts.shape[0]
    px, py = tr.warp_pixel_centers(width, height, origin, "cpu")
    x0, x1 = px.amin(-1)[:, None], px.amax(-1)[:, None]   # (n, 1, WARPS)
    y0, y1 = py.amin(-1)[:, None], py.amax(-1)[:, None]
    shape = (n_tiles, tr.WARPS, tr.WARP_W * tr.WARP_H)
    zl = torch.full((n_tiles, layers) + shape[1:], INF)
    il = torch.full((n_tiles, layers) + shape[1:], -1, dtype=torch.int32)
    zcap = torch.full(shape, INF) if zhi is None else tr._by_warp(zhi[:, 0])
    zlim = zcap.clone()
    kk = torch.arange(tr.KG)
    for s in range(int(counts.max())):
        for g in range(tr.G):
            act = torch.nonzero((counts > s)
                                & (((glists[:, s] >> g) & 1) != 0)).squeeze(1)
            if act.numel() == 0:
                continue
            ids = lists[act, s, None].long() * tr.CT + g * tr.KG + kk
            r = cols[:, ids]                                 # (ncol, A, KG)
            rect = (x0[act], x1[act], y0[act], y1[act])
            edge = torch.ones((act.numel(), tr.KG, tr.WARPS), dtype=bool)
            for e in range(3):
                edge &= tr._edge_may_pass(r[e][..., None], r[3 + e][..., None],
                                          r[6 + e][..., None],
                                          r[9 + e][..., None], *rect)
            xa, ya = px[act], py[act]
            for k in range(tr.KG):
                c = r[:, :, k][..., None, None]              # (ncol, A, 1, 1)
                inside = ((c[0] * xa + c[3] * ya + c[6] > c[9])
                          & (c[1] * xa + c[4] * ya + c[7] > c[10])
                          & (c[2] * xa + c[5] * ya + c[8] > c[11]))
                z = c[12] * xa + c[13] * ya + c[14]
                cand = inside & (z >= 0) & (z < INF) & (z <= zlim[act])
                assert not bool((cand & ~edge[:, k, :, None]).any())
                ok = cand & edge[:, k, :, None]
                if not bool(ok.any()):
                    continue
                if opaque_cull:
                    tex = c[tr.TEX_ROW]
                    opq = (tex == torch.floor(tex))
                    zcap[act] = torch.where(ok & opq, z, zcap[act])
                zc = torch.where(ok, z, INF)
                ic = torch.where(ok, ids[:, k, None, None].int(), -1)
                za, ia = zl[act], il[act]
                for layer in range(layers):
                    ze, ie = za[:, layer].clone(), ia[:, layer].clone()
                    swap = ok & ((zc < ze) | ((zc == ze) & (ic > ie)))
                    za[:, layer] = torch.where(swap, zc, ze)
                    ia[:, layer] = torch.where(swap, ic, ie)
                    zc, ic = torch.where(swap, ze, zc), torch.where(swap, ie,
                                                                     ic)
                zl[act], il[act] = za, ia
                zlim[act] = torch.where(
                    ok, torch.fmin(za[:, layers - 1], zcap[act]), zlim[act])
    if opaque_cull:
        il = torch.where(zl > zcap[:, None], -1, il)
    zl = torch.where(il >= 0, zl, 1.0)

    def tile_major(x):           # (n, L, WARPS, 256) → (n, L, P)
        out = torch.empty((n_tiles, layers, tr.P), dtype=x.dtype)
        flat = torch.arange(tr.P)
        order = tr._by_warp(flat[None].expand(n_tiles, -1)).reshape(
            n_tiles, -1)
        out[:, :, order[0]] = x.reshape(n_tiles, layers, -1)
        return out

    return tile_major(zl), tile_major(il)


@pytest.mark.parametrize("scene,variant,layers", [
    ("stack", "full", 4), ("glass", "nocull_zhi", 2),
    ("adversarial", "full_zhi", 8)])
def test_kernel_loop_with_culls_equals_reference(scene, variant, layers):
    """The culled per-warp loop gives the plain version's lists exactly,
    and its cull drops only pairs with no candidate."""
    args, kw = k2_case(scene, variant)
    zl, il = tr.raster_fwd_ml_reference(*args, layers=layers, **kw)[:2]
    assert bool((il >= 0).any())
    mz, mi = kernel_model(*args, layers=layers, **kw)
    assert torch.equal(mi, il) and torch.equal(mz, zl)


def test_k2_tool_inputs_and_refusal(monkeypatch):
    """The roofline's ``--k2`` cases at a small size: each K2 launch as
    the frames make it (the glass cases over the translucent set behind
    K1's opaque z-buffer; the opaque ones with the opaque cull, no
    horizon); its timing refuses without a card."""
    monkeypatch.setattr(raster_roofline, "W", W)
    monkeypatch.setattr(raster_roofline, "H", H)
    for case, (_, split, mode, lit) in raster_roofline.K2_CASES.items():
        runs, got_mode = raster_roofline.k2_inputs(case, "cpu", views=1,
                                                   instances=9, subdiv=1)
        (args, kw), = runs
        assert got_mode == mode and kw["opaque_cull"] is not split
        assert (kw["zhi"] is not None) is split
        assert (kw["light"] is not None) is lit
        assert args[0].shape[0] == tr.N_RAST + (tr.N_COEF_LIT if lit
                                                else tr.N_COEF)
        zl, il = tr.raster_fwd_ml(*args, layers=2, **kw)[:2]
        assert bool((il >= 0).any())
    with pytest.raises(ValueError, match="unknown K2 case"):
        raster_roofline.k2_inputs("world", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            raster_roofline.k2_breakdown(runs, 2)


def test_layout_matches_the_kernel_header():
    """K2's source builds on raster_group.cuh (through pair_ring.cuh),
    whose layout ``raster.LAYOUT`` copies, and launches PARTS CTAs of
    that layout's threads a tile."""
    csrc = Path(tr.__file__).resolve().parent.parent / "csrc"

    def sources(name):
        src = (csrc / name).read_text()
        out = [src]
        for inc in re.findall(r'#include "([^"]+)"', src):
            out += sources(inc)
        return out

    ml = (csrc / "raster_fwd_ml.cu").read_text()
    src = "\n".join(sources("raster_fwd_ml.cu"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert (const("PARTS"), const("WARP_W"), const("WARP_H")) == \
        tr.LAYOUT[:3]
    assert "mtr_raster_layout" in src
    assert re.search(r"<<<a\.n_tiles \* PARTS, K1_THREADS,", ml)
    assert "warp_pixels(blockIdx.x % PARTS" in ml
    assert "warp_cull(st, w)" in ml and "for_each_pair<" in ml
