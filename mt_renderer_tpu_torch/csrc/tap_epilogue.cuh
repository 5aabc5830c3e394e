// Tile geometry and the raster epilogues shared by the raster kernels K1
// (raster_fwd.cu) and K2 (raster_fwd_ml.cu).
//
// The epilogues are the three branches of the TPU kernels' _epilogue_rows
// (mt_renderer_tpu/render/pallas_raster.py:439), lit or unlit. Each loads
// a kept triangle's coefficient columns by global id from the
// column-major (ncol, Tp) setup matrix and evaluates them at the pixel
// center:
//   tap   -- the mip-0 quad-pool row of the bilinear tap, the tap
//            fractions fx, fy and the C rgba columns (6 planes + the row);
//   mtap  -- perspective u, v, the texture constants (tex, off hi/lo, th,
//            tw), C rgba and the winner's U/V/Q plane gradients divided by
//            Q (17 planes), which the trilinear shade turns into an
//            analytic LOD;
//   attrs -- K1 only, the multipass peel's: the u/w, v/w and 1/w planes
//            at the pixel, the texture constants and C rgba as stored
//            (tex, C rgba, off hi/lo, th, tw), lit the nx/w, ny/w, nz/w
//            planes, then the raw U/V/Q plane gradients (18 planes, 21
//            lit); the shade (device.shade_fwd) divides by Q and lights.
// The lit variants read 27 coefficient columns instead of 18 (the nx, ny,
// nz over w planes follow); tap and mtap scale C rgb by the lambert factor
// 0.3 + 0.7 * max(n.l / max(|n|, 1e-6), 0), alpha unlit. An id < 0
// evaluates zero coefficients, as the reference does: tapidx 0, every
// plane 0.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mtr {

constexpr int TILE_H = 16;
constexpr int TILE_W = 128;
constexpr int P = TILE_H * TILE_W;   // pixels per tile
constexpr int CT = 384;              // triangles per chunk
constexpr int KG = 32;               // triangles per culling group
constexpr int G = CT / KG;           // groups per chunk
constexpr int NRAST = 15;            // ea[3] eb[3] ec[3] bias[3] z-plane[3]
constexpr int NCOEF = 18;            // u/w v/w 1/w planes, tex, C rgba,
                                     // off hi/lo, th, tw
constexpr int NCOEF_LIT = NCOEF + 9; // + nx/w ny/w nz/w planes
constexpr int TEX_ROW = NRAST + 9;   // tex column: integer = opaque
constexpr int NTAP = 6;              // fx, fy, C rgba
constexpr int NMTAP = 17;            // u, v, tex, off hi/lo, th, tw, C rgba,
                                     // U_x U_y V_x V_y Q_x Q_y over Q
constexpr int NATTRS = 18;           // u/w v/w 1/w, tex, C rgba, off hi/lo,
                                     // th, tw, U_x U_y V_x V_y Q_x Q_y
constexpr int NATTRS_LIT = NATTRS + 3;  // + nx/w ny/w nz/w after tw

// The epilogue modes: the bilinear tap, the trilinear mip tap, the plain
// attributes (K1 only).
enum Mode { TAP = 0, MTAP = 1, ATTRS = 2 };

// The unit light direction of the lit epilogues.
struct Light {
  float x, y, z;
};

template <int NC>
__device__ __forceinline__ void load_coefs(const float* __restrict__ cols,
                                           int tp, int id, float (&a)[NC]) {
#pragma unroll
  for (int i = 0; i < NC; ++i)
    a[i] = id >= 0 ? cols[(size_t)(NRAST + i) * tp + id] : 0.0f;
}

// Plane i of the coefficients at the pixel center.
__device__ __forceinline__ float plane(const float* a, int i, float px,
                                       float py) {
  return a[i] * px + a[i + 1] * py + a[i + 2];
}

// 1 / (1/w plane), with |1/w| clamped below by w_eps.
__device__ __forceinline__ float persp_inv(const float* a, float px,
                                           float py, float w_eps) {
  const float w1 = plane(a, 6, px, py);
  return 1.0f / (fabsf(w1) < w_eps ? w_eps : w1);
}

// Lambert factor from the normal planes (coefficients 18..26).
__device__ __forceinline__ float lit_scale(const float* a, float px,
                                           float py, float inv, Light l) {
  const float nx = plane(a, 18, px, py) * inv;
  const float ny = plane(a, 21, px, py) * inv;
  const float nz = plane(a, 24, px, py) * inv;
  const float ln = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-6f);
  const float ndl = fmaxf((l.x * nx + l.y * ny + l.z * nz) / ln, 0.0f);
  return 0.3f + 0.7f * ndl;
}

// A pixel's epilogue outputs: the NTAP or NMTAP planes and, in tap mode,
// the quad-pool row.
struct Planes {
  float v[NMTAP];
  int tapidx;
};

// The pixel's tap outputs: planes 0..NTAP-1 and its quad-pool row (or -1
// for an untextured triangle).
template <bool LIT>
__device__ __forceinline__ void tap_values(const float* __restrict__ cols,
                                           int tp, int id, float px,
                                           float py, float w_eps,
                                           Light light, Planes& o) {
  float a[LIT ? NCOEF_LIT : NCOEF];
  load_coefs(cols, tp, id, a);
  const float inv = persp_inv(a, px, py, w_eps);
  const float u = plane(a, 0, px, py) * inv;
  const float v = plane(a, 3, px, py) * inv;
  const float th = a[16];
  const float tw = a[17];
  const float xs = u * tw - 0.5f;
  const float ys = v * th - 0.5f;
  const float x0f = floorf(xs);
  const float y0f = floorf(ys);
  // truncation toward zero, saturating, NaN -> 0 (cvt.rzi.s32.f32)
  const int wwi = __float2int_rz(tw);
  const int hhi = __float2int_rz(th);
  const int x0c = min(max(__float2int_rz(x0f), 0), max(wwi - 1, 0));
  const int y0c = min(max(__float2int_rz(y0f), 0), max(hhi - 1, 0));
  const int offi = __float2int_rz(a[14]) * 4096 + __float2int_rz(a[15]);
  o.tapidx = a[9] >= 0.0f ? offi + y0c * wwi + x0c : -1;
  float s = 1.0f;
  if constexpr (LIT) s = lit_scale(a, px, py, inv, light);
  o.v[0] = x0f < 0.0f ? 0.0f : xs - x0f;
  o.v[1] = y0f < 0.0f ? 0.0f : ys - y0f;
  o.v[2] = LIT ? a[10] * s : a[10];
  o.v[3] = LIT ? a[11] * s : a[11];
  o.v[4] = LIT ? a[12] * s : a[12];
  o.v[5] = a[13];
}

// The pixel's mtap outputs: planes 0..NMTAP-1.
template <bool LIT>
__device__ __forceinline__ void mtap_values(const float* __restrict__ cols,
                                            int tp, int id, float px,
                                            float py, float w_eps,
                                            Light light, Planes& o) {
  float a[LIT ? NCOEF_LIT : NCOEF];
  load_coefs(cols, tp, id, a);
  const float inv = persp_inv(a, px, py, w_eps);
  float s = 1.0f;
  if constexpr (LIT) s = lit_scale(a, px, py, inv, light);
  o.v[0] = plane(a, 0, px, py) * inv;          // u
  o.v[1] = plane(a, 3, px, py) * inv;          // v
  o.v[2] = a[9];                               // tex (< 0: untextured)
  o.v[3] = a[14];                              // off hi
  o.v[4] = a[15];                              // off lo
  o.v[5] = a[16];                              // th
  o.v[6] = a[17];                              // tw
  o.v[7] = LIT ? a[10] * s : a[10];            // C rgba, alpha unlit
  o.v[8] = LIT ? a[11] * s : a[11];
  o.v[9] = LIT ? a[12] * s : a[12];
  o.v[10] = a[13];
  o.v[11] = a[0] * inv;                        // U_x, U_y over Q
  o.v[12] = a[1] * inv;
  o.v[13] = a[3] * inv;                        // V_x, V_y over Q
  o.v[14] = a[4] * inv;
  o.v[15] = a[6] * inv;                        // Q_x, Q_y over Q
  o.v[16] = a[7] * inv;
}

// Writes plane c of the pixel's tap outputs to ta[c * P] and its quad-pool
// row to *tapidx.
template <bool LIT>
__device__ __forceinline__ void tap_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float w_eps, Light light, float* __restrict__ ta,
    int* __restrict__ tapidx) {
  Planes o;
  tap_values<LIT>(cols, tp, id, px, py, w_eps, light, o);
#pragma unroll
  for (int c = 0; c < NTAP; ++c) ta[c * P] = o.v[c];
  *tapidx = o.tapidx;
}

// Writes plane c of the pixel's mtap outputs to ta[c * P].
template <bool LIT>
__device__ __forceinline__ void mtap_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float w_eps, Light light, float* __restrict__ ta) {
  Planes o;
  mtap_values<LIT>(cols, tp, id, px, py, w_eps, light, o);
#pragma unroll
  for (int c = 0; c < NMTAP; ++c) ta[c * P] = o.v[c];
}

// Writes plane c of the pixel's attrs outputs (NATTRS or NATTRS_LIT
// planes) to ta[c * P].
template <bool LIT>
__device__ __forceinline__ void attrs_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float* __restrict__ ta) {
  float a[LIT ? NCOEF_LIT : NCOEF];
  load_coefs(cols, tp, id, a);
  ta[0] = plane(a, 0, px, py);                 // u/w
  ta[P] = plane(a, 3, px, py);                 // v/w
  ta[2 * P] = plane(a, 6, px, py);             // 1/w
#pragma unroll
  for (int i = 0; i < 9; ++i)                  // tex, C rgba, off hi/lo,
    ta[(3 + i) * P] = a[9 + i];                // th, tw
  constexpr int G0 = LIT ? 15 : 12;            // first gradient plane
  if constexpr (LIT) {
    ta[12 * P] = plane(a, 18, px, py);         // nx/w, ny/w, nz/w
    ta[13 * P] = plane(a, 21, px, py);
    ta[14 * P] = plane(a, 24, px, py);
  }
  ta[G0 * P] = a[0];                           // U_x, U_y
  ta[(G0 + 1) * P] = a[1];
  ta[(G0 + 2) * P] = a[3];                     // V_x, V_y
  ta[(G0 + 3) * P] = a[4];
  ta[(G0 + 4) * P] = a[6];                     // Q_x, Q_y
  ta[(G0 + 5) * P] = a[7];
}

}  // namespace mtr
