// Tile geometry and the bilinear-tap epilogue shared by the raster
// kernels K1 (raster_fwd.cu) and K2 (raster_fwd_ml.cu).
//
// The epilogue is the tap branch of the TPU kernels' _epilogue_rows
// (mt_renderer_tpu/render/pallas_raster.py:439): it loads a kept
// triangle's 18 coefficient columns by global id from the column-major
// (ncol, Tp) setup matrix and evaluates, at the pixel center, the mip-0
// quad-pool row of the bilinear tap, the tap fractions fx, fy and the
// C rgba columns. An id < 0 evaluates zero coefficients, as the
// reference does: tapidx 0, fx = fy = 0, C = 0.

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
constexpr int TEX_ROW = NRAST + 9;   // tex column: integer = opaque
constexpr int NTAP = 6;              // fx, fy, C rgba
constexpr int THREADS = 256;
constexpr int PPT = P / THREADS;     // pixels per thread
constexpr int ROWS_PER_PASS = THREADS / TILE_W;

// Writes plane c of the pixel's tap outputs to ta[c * P] and its quad-pool
// row (or -1 for an untextured triangle) to *tapidx.
__device__ __forceinline__ void tap_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float w_eps, float* __restrict__ ta, int* __restrict__ tapidx) {
  float a[NCOEF];
#pragma unroll
  for (int i = 0; i < NCOEF; ++i)
    a[i] = id >= 0 ? cols[(size_t)(NRAST + i) * tp + id] : 0.0f;
  const float w1 = a[6] * px + a[7] * py + a[8];
  const float inv = 1.0f / (fabsf(w1) < w_eps ? w_eps : w1);
  const float u = (a[0] * px + a[1] * py + a[2]) * inv;
  const float v = (a[3] * px + a[4] * py + a[5]) * inv;
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
  ta[0 * P] = x0f < 0.0f ? 0.0f : xs - x0f;
  ta[1 * P] = y0f < 0.0f ? 0.0f : ys - y0f;
  ta[2 * P] = a[10];
  ta[3 * P] = a[11];
  ta[4 * P] = a[12];
  ta[5 * P] = a[13];
}

}  // namespace mtr
