"""The plain reference renderer: what a frame of a configuration must be.

Plain PyTorch on any device, written from the renderer's stated rules
and importing nothing of the program:

* skinning: each vertex's matrix is the weighted sum of its palette
  matrices (weights of joints outside the palette count 0); a vertex
  with no weight passes through unskinned;
* clip = view_proj @ [p, 1]; a triangle with any w <= 1e-6 is culled,
  as is a back face (doubled screen area >= 0 in y-down pixels);
* viewport px = (x/w + 1)/2 W, py = (1 - y/w)/2 H, samples at pixel
  centers; edge functions with a snap band of 1e-6 (|A| W + |B| H + |C|)
  in which the top-left rule decides;
* depth z/w interpolated linearly in screen space, kept where z >= 0;
  the nearest fragment wins, the later triangle on an exact tie (the
  LessEqual test in triangle order); 1.0 where nothing is covered;
* perspective-correct uv; bilinear clamp-to-edge texel taps; with
  ``mipmap`` a trilinear tap at the analytic LOD (log2 of the largest
  texel-space derivative of u or v), both levels clamped to the
  texture's last, over 2x2 box-filtered mip chains built here, or, for
  a scene that ships compressed chains, over those chains' levels as
  ``reference_bcn`` decodes them;
* albedo times the slot's material color, blended src-alpha over the
  clear color, rounded half up to RGBA8.

Every float is computed in ``dtype`` (the check judges in float64; the
control runs the same code in bfloat16, the precision below the
configuration's float32); the depth test keeps z as float32 bits, so
depths are ordered to float32's step. The raster works per
triangle over its own pixel blocks, so its cost follows the covered
area, not triangles x pixels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import reference_bcn

W_EPS = 1e-6
_NONE = torch.iinfo(torch.int64).max


# ------------------------------------------------------------- palette


def _sample(keys, frame: float) -> float:
    """A linear track [[frame, value], ...] at ``frame`` (held before
    the first key and after the last)."""
    if frame <= keys[0][0]:
        return float(keys[0][1])
    for (f0, v0), (f1, v1) in zip(keys, keys[1:]):
        if frame < f1:
            return float(v0) + (frame - f0) / (f1 - f0) * (float(v1) - float(v0))
    return float(keys[-1][1])


def _euler(rx, ry, rz, tx, ty, tz) -> np.ndarray:
    """T(t) Rz Ry Rx as a (4, 4) f64 matrix."""
    def rot(axis, a):
        c, s = math.cos(a), math.sin(a)
        m = np.eye(4)
        i, j = [(1, 2), (2, 0), (0, 1)][axis]
        m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
        return m
    m = rot(2, rz) @ rot(1, ry) @ rot(0, rx)
    m[:3, 3] = (tx, ty, tz)
    return m


def palette(anim: dict, t: float) -> np.ndarray:
    """The bone palette (J, 4, 4) at animation time ``t`` seconds, in f64.

    ``two_bone``: bone ``bone`` moves ``amplitude`` sin(t phase_per_s)
    in x. ``timeline``: frame (t fps) mod duration of linear tracks
    ``joint<j>:<rx|ry|rz|tx|ty|tz>`` on an 8-joint skeleton (identity
    rest and inverse binds), world_j = world_parent (delta_j), placed
    per character as C_i P_j C_i^-1."""
    if anim["kind"] == "two_bone":
        m = np.tile(np.eye(4), (2, 1, 1))
        m[anim["bone"], 0, 3] = anim["amplitude"] * math.sin(
            t * anim["phase_per_s"])
        return m
    if anim["kind"] != "timeline":
        raise ValueError(f"unknown animation {anim['kind']!r}")
    frame = math.fmod(t * anim["fps"], anim["duration"])
    parents = anim["parents"]
    world = []
    for j, p in enumerate(parents):
        v = {k: 0.0 for k in ("rx", "ry", "rz", "tx", "ty", "tz")}
        for name, keys in anim["tracks"].items():
            jn, param = name.split(":")
            if int(jn[len("joint"):]) == j:
                v[param] = _sample(keys, frame)
        delta = _euler(v["rx"], v["ry"], v["rz"], v["tx"], v["ty"], v["tz"])
        world.append(delta if p < 0 else world[p] @ delta)
    base = np.stack(world)
    chars = np.asarray(anim["characters"], np.float64)
    inv = np.linalg.inv(chars)
    return np.einsum("cik,jkl,clm->cjim", chars, base, inv).reshape(-1, 4, 4)


# ------------------------------------------------------------ textures


def mip_chain(img: np.ndarray) -> list:
    """2x2 box-filter pyramid of an (h, w, 4) u8 image down to 1x1,
    each level rounded half up ((sum + 2) >> 2, or (sum + 1) >> 1 along
    one axis)."""
    chain = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        h, w = img.shape[:2]
        x = img.astype(np.uint32)
        if h > 1:
            x = x[: h // 2 * 2].reshape(h // 2, 2, -1, 4).sum(1)
        if w > 1:
            x = x[:, : w // 2 * 2].reshape(x.shape[0], w // 2, 2, 4).sum(2)
        n = (2 if h > 1 else 1) * (2 if w > 1 else 1)
        img = ((x + n // 2) // n).astype(np.uint8)
        chain.append(img)
    return chain


class Scene:
    """A configuration's scene on ``device``, every float in ``dtype``:
    the geometry and, for the texel taps, each texture's mip chain in one
    flat (N, 4) texel array with per-(texture, level) offsets."""

    def __init__(self, arrays, cfg: dict, device, dtype=torch.float32):
        if (np.asarray(arrays.tri_texture) < 0).any():
            raise ValueError("the reference shades textured triangles only")
        dev = torch.device(device)
        self.device, self.dtype = dev, dtype
        self.width, self.height = cfg["width"], cfg["height"]
        self.mipmap = bool(cfg["mipmap"])

        def f(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dtype)

        def i(x):
            return torch.as_tensor(np.asarray(x), device=dev).long()

        self.positions, self.uvs, self.weights = (
            f(arrays.positions), f(arrays.uvs), f(arrays.weights))
        self.joints, self.tris = i(arrays.joints), i(arrays.tris)
        self.tri_texture, self.tri_material = (
            i(arrays.tri_texture), i(arrays.tri_material))
        self.mat_color = f(arrays.mat_color)
        if arrays.chains is not None:
            decode = {"bc1": reference_bcn.decode_bc1,
                      "bc7": reference_bcn.decode_bc7}[arrays.chain_format]
            chains = [[decode(*lvl) for lvl in c[:None if self.mipmap else 1]]
                      for c in arrays.chains]
        else:
            chains = [mip_chain(t) if self.mipmap else [t]
                      for t in arrays.textures]
        self.num_mips = max(len(c) for c in chains)
        offs = np.zeros((len(chains), self.num_mips), np.int64)
        flat, n = [], 0
        for k, chain in enumerate(chains):
            for m, lvl in enumerate(chain):
                offs[k, m] = n
                flat.append(lvl.reshape(-1, 4))
                n += lvl.shape[0] * lvl.shape[1]
        self.texels = f(np.concatenate(flat))
        self.level_off = i(offs)
        self.tex_hw = i([t.shape[:2] for t in arrays.textures])
        self.clear = f(np.asarray(cfg["clear_color"], np.float32))

    # ---------------------------------------------------------- stages

    def clip(self, view_proj, pal) -> torch.Tensor:
        """Skinned vertices → (V, 4) clip coordinates."""
        dt, pos = self.dtype, self.positions
        if pal is not None:
            mats = torch.as_tensor(np.asarray(pal, np.float64),
                                   device=self.device).to(dt).reshape(-1, 16)
            nj = mats.shape[0]
            ok = (self.joints >= 0) & (self.joints < nj)
            w = torch.where(ok, self.weights, torch.zeros_like(self.weights))
            m = mats[self.joints.clamp(0, nj - 1)]              # (V, W, 16)
            blend = (w[..., None] * m).sum(1).reshape(-1, 4, 4)
            sk = (blend[:, :3, :3] * pos[:, None, :]).sum(-1) + blend[:, :3, 3]
            pos = torch.where((self.weights.sum(1) > 0)[:, None], sk, pos)
        vp = torch.as_tensor(np.asarray(view_proj, np.float64),
                             device=self.device).to(dt)
        # elementwise products and sums: no matrix unit, so no TF32
        return (pos[:, None, :] * vp[None, :, :3]).sum(-1) + vp[:, 3]

    def setup(self, clip) -> dict:
        """Per-triangle screen setup → dict of (T, ...) tensors."""
        w_, h_ = self.width, self.height
        c = clip[self.tris]                                    # (T, 3, 4)
        w = c[..., 3]
        inv_w = 1.0 / torch.where(w.abs() < W_EPS, torch.full_like(w, W_EPS), w)
        sx = (c[..., 0] * inv_w + 1.0) * (0.5 * w_)
        sy = (1.0 - c[..., 1] * inv_w) * (0.5 * h_)
        sz = c[..., 2] * inv_w
        area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
                 - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
        valid = (w > W_EPS).all(1) & (area2 < 0)
        a, b = [1, 2, 0], [2, 0, 1]
        ax, ay, bx, by = sx[:, a], sy[:, a], sx[:, b], sy[:, b]
        ea = by - ay
        eb = -(bx - ax)
        ec = ay * (bx - ax) - ax * (by - ay)
        return dict(
            ea=ea, eb=eb, ec=ec, area=-area2, sz=sz, inv_w=inv_w,
            valid=valid, topleft=((ay == by) & (bx < ax)) | (by > ay),
            snap=1e-6 * (ea.abs() * w_ + eb.abs() * h_ + ec.abs()),
            lo=torch.stack([sx.amin(1), sy.amin(1)], 1),
            hi=torch.stack([sx.amax(1), sy.amax(1)], 1))

    def _inside(self, st, t, px, py):
        """Coverage and depth of triangles ``t`` (N,) at pixel centers
        px (N, 1, B), py (N, B, 1) → (cov, z) each (N, B, B)."""
        e = [st["ea"][t, k, None, None] * px + st["eb"][t, k, None, None] * py
             + st["ec"][t, k, None, None] for k in range(3)]
        cov = st["valid"][t, None, None]
        for k in range(3):
            snap = st["snap"][t, k, None, None]
            cov = cov & torch.where(st["topleft"][t, k, None, None],
                                    e[k] >= -snap, e[k] > snap)
        inv = 1.0 / st["area"][t, None, None]
        z = sum(st["sz"][t, k, None, None] * (e[k] * inv) for k in range(3))
        return cov, z

    def _fragments(self, st):
        """Every covered fragment, in batches → (pixel (F,) int64 index
        y W + x, triangle (F,) int64, z (F,) f32), each triangle over its
        own pixel blocks."""
        w_, h_, dev = self.width, self.height, self.device
        lo = torch.floor(st["lo"].float().clamp(-2.0, 1e5)).long() - 1
        hi = torch.ceil(st["hi"].float().clamp(-2.0, 1e5)).long() + 1
        lo = torch.maximum(lo, torch.zeros_like(lo))
        hi = torch.minimum(hi, torch.tensor([w_ - 1, h_ - 1], device=dev))
        ext = (hi - lo + 1).amax(1)
        live = st["valid"] & (hi >= lo).all(1)
        prev = 0
        for size in (4, 8, 16, 32):
            pick = live & (ext > prev) & ((ext <= size) | (size == 32))
            prev = size
            t = torch.nonzero(pick)[:, 0]
            if not len(t):
                continue
            nb = ((hi[t] - lo[t]) // size + 1)                 # (n, 2) blocks
            count = nb[:, 0] * nb[:, 1]
            t = torch.repeat_interleave(t, count)
            first = torch.cumsum(count, 0) - count
            k = torch.arange(len(t), device=dev) - torch.repeat_interleave(
                first, count)
            nbx = torch.repeat_interleave(nb[:, 0], count)
            x0 = lo[t, 0] + (k % nbx) * size
            y0 = lo[t, 1] + (k // nbx) * size
            step = max(1, (8 << 20) // (size * size))
            ar = torch.arange(size, device=dev)
            for s in range(0, len(t), step):
                tt, xx, yy = t[s:s + step], x0[s:s + step], y0[s:s + step]
                xi = xx[:, None, None] + ar[None, None, :]
                yi = yy[:, None, None] + ar[None, :, None]
                cov, z = self._inside(st, tt, (xi.to(self.dtype) + 0.5),
                                      (yi.to(self.dtype) + 0.5))
                ok = cov & (xi < w_) & (yi < h_) & (z >= 0)
                n, yy_, xx_ = torch.nonzero(ok, as_tuple=True)
                zf = z[n, yy_, xx_].float()
                zf = torch.where(zf > 0, zf, torch.zeros_like(zf))   # no -0.0
                yield yi[n, yy_, 0] * w_ + xi[n, 0, xx_], tt[n], zf

    def raster(self, st) -> torch.Tensor:
        """Visibility → (H*W,) int64 keys (z bits << 32 | ~triangle), or
        int64 max where nothing is covered."""
        keys = torch.full((self.height * self.width,), _NONE,
                          dtype=torch.int64, device=self.device)
        for pix, t, z in self._fragments(st):
            key = (z.contiguous().view(torch.int32).long() << 32) | (
                0xFFFFFFFF - t)
            keys.scatter_reduce_(0, pix, key, "amin")
        return keys

    def near_front(self, st, keys, eps: float):
        """The fragments whose z lies within ``eps`` of their pixel's
        nearest → (pixel, triangle) (F,) each: the surfaces whose order at
        that pixel a float32 depth cannot tell apart (the winner among
        them)."""
        zmin = (keys >> 32).to(torch.int32).view(torch.float32)
        pixs, tris = [], []
        for pix, t, z in self._fragments(st):
            near = z <= zmin[pix] + eps
            pixs.append(pix[near])
            tris.append(t[near])
        return torch.cat(pixs), torch.cat(tris)

    def _tap(self, tex, m, u, v) -> torch.Tensor:
        """Bilinear clamp-to-edge tap of level ``m`` → (P, 4)."""
        th, tw = self.tex_hw[tex, 0], self.tex_hw[tex, 1]
        hm, wm = (th >> m).clamp(min=1), (tw >> m).clamp(min=1)
        x = u * wm.to(self.dtype) - 0.5
        y = v * hm.to(self.dtype) - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx = torch.where(x0 < 0, torch.zeros_like(x), x - x0)[:, None]
        fy = torch.where(y0 < 0, torch.zeros_like(y), y - y0)[:, None]
        xa = torch.minimum(x0.float().clamp(0, 1e6).long(), wm - 1)
        ya = torch.minimum(y0.float().clamp(0, 1e6).long(), hm - 1)
        xb, yb = torch.minimum(xa + 1, wm - 1), torch.minimum(ya + 1, hm - 1)
        off = self.level_off[tex, m]
        t = self.texels
        return ((1 - fx) * (1 - fy) * t[off + ya * wm + xa]
                + fx * (1 - fy) * t[off + ya * wm + xb]
                + (1 - fx) * fy * t[off + yb * wm + xa]
                + fx * fy * t[off + yb * wm + xb])

    def colors(self, st, pix, t) -> torch.Tensor:
        """Triangle ``t`` shaded at pixel ``pix`` (each (P,)) → (P, 4) u8
        RGBA."""
        w_, dt = self.width, self.dtype
        px = (pix % w_).to(dt)[:, None] + 0.5
        py = (pix // w_).to(dt)[:, None] + 0.5
        area = st["area"][t][:, None]
        e = st["ea"][t] * px + st["eb"][t] * py + st["ec"][t]   # (P, 3)
        bw = (e / area) * st["inv_w"][t]
        pw = bw.sum(1)
        uv = self.uvs[self.tris[t]]                             # (P, 3, 2)
        u = (bw * uv[..., 0]).sum(1) / pw
        v = (bw * uv[..., 1]).sum(1) / pw
        tex = self.tri_texture[t]
        if self.mipmap:
            ax = (st["ea"][t] / area) * st["inv_w"][t]
            ay = (st["eb"][t] / area) * st["inv_w"][t]
            ipw = 1.0 / pw
            dudx = (ax * uv[..., 0]).sum(1) * ipw - u * (ax.sum(1) * ipw)
            dudy = (ay * uv[..., 0]).sum(1) * ipw - u * (ay.sum(1) * ipw)
            dvdx = (ax * uv[..., 1]).sum(1) * ipw - v * (ax.sum(1) * ipw)
            dvdy = (ay * uv[..., 1]).sum(1) * ipw - v * (ay.sum(1) * ipw)
            th, tw = self.tex_hw[tex, 0], self.tex_hw[tex, 1]
            rho = torch.maximum(
                torch.maximum(dudx.abs(), dudy.abs()) * tw.to(dt),
                torch.maximum(dvdx.abs(), dvdy.abs()) * th.to(dt))
            lod = torch.log2(rho.clamp(min=1e-6))
            lod = lod.clamp(0.0, float(self.num_mips - 1))
            m0f = torch.floor(lod)
            fm = (lod - m0f)[:, None]
            top = torch.floor(torch.log2(torch.maximum(th, tw).double())).long()
            m0 = torch.minimum(m0f.float().long(), top)
            m1 = torch.minimum(m0 + 1, top)
            albedo = (self._tap(tex, m0, u, v) * (1 - fm)
                      + self._tap(tex, m1, u, v) * fm)
        else:
            albedo = self._tap(tex, torch.zeros_like(tex), u, v)
        src = albedo * self.mat_color[self.tri_material[t]]
        a = src[:, 3:] / 255.0
        out = torch.cat([src[:, :3] * a + self.clear[:3] * (1 - a),
                         src[:, 3:]], 1)
        return (out.float() + 0.5).clamp(0, 255).to(torch.uint8)

    def shade(self, st, keys):
        """Winners → ((H, W, 4) u8, (H, W) f32 depth, (H, W) covered)."""
        w_, h_ = self.width, self.height
        covered = keys != _NONE
        pix = torch.nonzero(covered)[:, 0]
        t = 0xFFFFFFFF - (keys[pix] & 0xFFFFFFFF)
        rgba = (self.clear.float() + 0.5).clamp(0, 255).to(
            torch.uint8).expand(h_ * w_, 4).clone()
        rgba[pix] = self.colors(st, pix, t)
        depth = torch.ones(h_ * w_, dtype=torch.float32, device=self.device)
        depth[pix] = (keys[pix] >> 32).to(torch.int32).view(torch.float32)
        return (rgba.reshape(h_, w_, 4), depth.reshape(h_, w_),
                covered.reshape(h_, w_))

    def render(self, view_proj, pal, eps: float | None = None):
        """One frame → ((H, W, 4) u8 RGBA, (H, W) f32 depth, covered),
        and with ``eps`` the near-front fragments' (pixel (F,), (F, 4) u8
        RGBA) after them (``near_front``)."""
        st = self.setup(self.clip(view_proj, pal))
        keys = self.raster(st)
        frame = self.shade(st, keys)
        if eps is None:
            return frame
        pix, t = self.near_front(st, keys, eps)
        return frame + (pix, self.colors(st, pix, t))
