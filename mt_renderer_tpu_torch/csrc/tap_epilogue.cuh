// Tile geometry and the raster epilogues shared by the raster kernels K1
// (raster_fwd.cu) and K2 (raster_fwd_ml.cu).
//
// The epilogues are the tap and mtap branches of the TPU kernels'
// _epilogue_rows (mt_renderer_tpu/render/pallas_raster.py:439), lit or
// unlit. Each loads a kept triangle's coefficient columns by global id
// from the column-major (ncol, Tp) setup matrix and evaluates them at the
// pixel center:
//   tap  -- the mip-0 quad-pool row of the bilinear tap, the tap fractions
//           fx, fy and the C rgba columns (6 planes + the row);
//   mtap -- perspective u, v, the texture constants (tex, off hi/lo, th,
//           tw), C rgba and the winner's U/V/Q plane gradients divided by
//           Q (17 planes), which the trilinear shade turns into an
//           analytic LOD.
// The lit variants read 27 coefficient columns instead of 18 (the nx, ny,
// nz over w planes follow) and scale C rgb by the lambert factor
// 0.3 + 0.7 * max(n.l / max(|n|, 1e-6), 0); alpha stays unlit. An id < 0
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
constexpr int THREADS = 256;         // K2's CTA: one tile (K1's layout is
                                     // raster_group.cuh's)
constexpr int PPT = P / THREADS;     // pixels per thread
constexpr int ROWS_PER_PASS = THREADS / TILE_W;

// The epilogue modes: the bilinear tap, the trilinear mip tap.
enum Mode { TAP = 0, MTAP = 1 };

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

// Writes plane c of the pixel's tap outputs to ta[c * P] and its quad-pool
// row (or -1 for an untextured triangle) to *tapidx.
template <bool LIT>
__device__ __forceinline__ void tap_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float w_eps, Light light, float* __restrict__ ta,
    int* __restrict__ tapidx) {
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
  *tapidx = a[9] >= 0.0f ? offi + y0c * wwi + x0c : -1;
  float s = 1.0f;
  if constexpr (LIT) s = lit_scale(a, px, py, inv, light);
  ta[0 * P] = x0f < 0.0f ? 0.0f : xs - x0f;
  ta[1 * P] = y0f < 0.0f ? 0.0f : ys - y0f;
  ta[2 * P] = LIT ? a[10] * s : a[10];
  ta[3 * P] = LIT ? a[11] * s : a[11];
  ta[4 * P] = LIT ? a[12] * s : a[12];
  ta[5 * P] = a[13];
}

// Writes plane c of the pixel's mtap outputs to ta[c * P].
template <bool LIT>
__device__ __forceinline__ void mtap_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float w_eps, Light light, float* __restrict__ ta) {
  float a[LIT ? NCOEF_LIT : NCOEF];
  load_coefs(cols, tp, id, a);
  const float inv = persp_inv(a, px, py, w_eps);
  float s = 1.0f;
  if constexpr (LIT) s = lit_scale(a, px, py, inv, light);
  ta[0 * P] = plane(a, 0, px, py) * inv;       // u
  ta[1 * P] = plane(a, 3, px, py) * inv;       // v
  ta[2 * P] = a[9];                            // tex (< 0: untextured)
  ta[3 * P] = a[14];                           // off hi
  ta[4 * P] = a[15];                           // off lo
  ta[5 * P] = a[16];                           // th
  ta[6 * P] = a[17];                           // tw
  ta[7 * P] = LIT ? a[10] * s : a[10];         // C rgba, alpha unlit
  ta[8 * P] = LIT ? a[11] * s : a[11];
  ta[9 * P] = LIT ? a[12] * s : a[12];
  ta[10 * P] = a[13];
  ta[11 * P] = a[0] * inv;                     // U_x, U_y over Q
  ta[12 * P] = a[1] * inv;
  ta[13 * P] = a[3] * inv;                     // V_x, V_y over Q
  ta[14 * P] = a[4] * inv;
  ta[15 * P] = a[6] * inv;                     // Q_x, Q_y over Q
  ta[16 * P] = a[7] * inv;
}

}  // namespace mtr
