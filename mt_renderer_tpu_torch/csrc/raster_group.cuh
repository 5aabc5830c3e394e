// The single-layer raster's CTA layout and group body, shared by the
// production raster K1 (raster_fwd.cu) and its speed-of-light probe K3
// (raster_micro.cu), so that the probe prices the exact op mix of the
// production kernel; the multi-layer raster K2 (raster_fwd_ml.cu) runs
// the same layout and cull. The counterpart of _sl_group_body
// (mt_renderer_tpu/render/pallas_raster.py:532), which the TPU kernels
// share the same way; the one-hot coefficient select of that body is
// gone: the kernels load the winner's columns by id in their epilogues.
//
// Layout. A CTA owns one PART_W x TILE_H part of a 16x128 tile (PARTS
// CTAs per tile, so a 16x32 part) with K1_WARPS warps; each warp owns a
// compact WARP_W x WARP_H block of pixels and each lane one column of it
// (K1_PPT pixels). A warp's writes of one pixel row are 128 contiguous
// bytes.
//
// Group body. A staged group is its 15 raster columns, [NRAST][KG]
// floats. Each lane first tests one of the group's 32 triangles against
// its warp's rectangle of pixel centers (warp_cull); the warp then
// evaluates only the triangles whose bit survived, in ascending order,
// at its K1_PPT pixels per lane.
//
// The cull is exact, per edge. The rectangle's corners are pixel centers
// of the warp, and the per-pixel value e = fl(fl(fl(a*x) + fl(b*y)) + c)
// never decreases as x moves toward the side picked by the sign of a, or
// y toward the side picked by the sign of b: each rounding is monotone.
// So the corner's value, computed with the pixels' own expression, is
// the largest computed value over the warp's pixels, and an edge whose
// corner value is <= its bias is failed by every one of them: the
// triangle covers none of the warp's pixels, and the winners are those
// of the full evaluation, bit for bit. The top-left rule and the snap
// band live in the bias, so they are tested exactly as the pixels test
// them; REJECT rows drop out unless their edge values overflow to +inf,
// which passes at the pixels too. A NaN at the corner (NaN coefficients,
// or inf - inf) never rejects.

#pragma once

#include "tap_epilogue.cuh"

namespace mtr {

constexpr int PARTS = 4;                      // CTAs per tile
constexpr int PART_W = TILE_W / PARTS;        // a CTA's columns
constexpr int WARP_W = 32;                    // a warp's pixel block
constexpr int WARP_H = 8;
constexpr int K1_WARPS = PART_W * TILE_H / (WARP_W * WARP_H);
constexpr int K1_THREADS = 32 * K1_WARPS;
constexpr int K1_PPT = WARP_H;                // pixels per lane: a column
constexpr unsigned GROUP_BITS = (1u << G) - 1u;

static_assert(PART_W % WARP_W == 0 && TILE_H % WARP_H == 0,
              "warp blocks tile a CTA's part");

// A lane's pixels and its warp's rectangle of pixel centers.
struct WarpPixels {
  float px;                 // the lane's column
  float py[K1_PPT];         // its rows
  int p0;                   // tile-local index of pixel 0; pixel j adds
                            // j * TILE_W
  float x0, x1, y0, y1;     // the warp's extreme pixel centers
};

// The lane's pixels in part `part` of the tile whose top-left pixel is
// (tx, ty), as the reference places pixel centers: column + (tx + 0.5).
__device__ __forceinline__ WarpPixels warp_pixels(int part, float tx,
                                                  float ty) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = part * PART_W + (warp % (PART_W / WARP_W)) * WARP_W;
  const int row = (warp / (PART_W / WARP_W)) * WARP_H;
  WarpPixels w;
  w.px = (float)(col + lane) + (tx + 0.5f);
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) w.py[j] = (float)(row + j) + (ty + 0.5f);
  w.p0 = row * TILE_W + col + lane;
  w.x0 = (float)col + (tx + 0.5f);
  w.x1 = (float)(col + WARP_W - 1) + (tx + 0.5f);
  w.y0 = (float)row + (ty + 0.5f);
  w.y1 = (float)(row + WARP_H - 1) + (ty + 0.5f);
  return w;
}

// False only if no pixel center of the warp's rectangle passes
// a*x + b*y + c > bias (see the header).
__device__ __forceinline__ bool edge_may_pass(float a, float b, float c,
                                              float bias,
                                              const WarpPixels& w) {
  const float m = a * (a >= 0.0f ? w.x1 : w.x0) +
                  b * (b >= 0.0f ? w.y1 : w.y0) + c;
  return !(m <= bias);
}

// The warp's live mask of the staged group: bit k set unless triangle k
// provably covers none of the warp's pixels.
__device__ __forceinline__ unsigned warp_cull(
    const float (*__restrict__ st)[KG], const WarpPixels& w) {
  const int k = threadIdx.x & 31;
  bool keep = true;
#pragma unroll
  for (int e = 0; e < 3; ++e)
    keep &= edge_may_pass(st[e][k], st[3 + e][k], st[6 + e][k],
                          st[9 + e][k], w);
  return __ballot_sync(0xffffffffu, keep);
}

// The staged group st (triangle k has global id id0 + k) against the
// lane's pixels. Every pixel keeps the lexicographic minimum of (z,
// -global id) over the candidates inside all three edges (e > bias) with
// 0 <= z < inf: the reference's group-min-then-update rule, so the order
// of groups and chunks is invisible.
//
// ZLOW (the multipass peel's exclusion, _sl_group_body's has_zlow): a
// candidate must also lie behind the pixel's zlo[j] (z > zlo[j]; +inf
// admits nothing, -inf everything). Only the per-pixel test reads it:
// warp_cull tests edges alone and stays exact. With ZLOW false (the
// default, which K1's tap and mtap paths, K2 and the probe K3 take)
// zlo is never read and the body is the one without the exclusion.
template <bool ZLOW = false>
__device__ __forceinline__ void raster_group(
    const float (*__restrict__ st)[KG], int id0, const WarpPixels& w,
    float (&zbest)[K1_PPT], int (&wid)[K1_PPT],
    const float* __restrict__ zlo = nullptr) {
  unsigned live = warp_cull(st, w);
  while (live) {
    const int k = __ffs(live) - 1;
    live &= live - 1;
    const float ea0 = st[0][k], ea1 = st[1][k], ea2 = st[2][k];
    const float eb0 = st[3][k], eb1 = st[4][k], eb2 = st[5][k];
    const float ec0 = st[6][k], ec1 = st[7][k], ec2 = st[8][k];
    const float bi0 = st[9][k], bi1 = st[10][k], bi2 = st[11][k];
    const float za = st[12][k], zb = st[13][k], zc = st[14][k];
    const int id = id0 + k;
    const float px = w.px;
#pragma unroll
    for (int j = 0; j < K1_PPT; ++j) {
      const float py = w.py[j];
      const float e0 = ea0 * px + eb0 * py + ec0;
      const float e1 = ea1 * px + eb1 * py + ec1;
      const float e2 = ea2 * px + eb2 * py + ec2;
      const float z = za * px + zb * py + zc;
      const bool ok = (e0 > bi0) && (e1 > bi1) && (e2 > bi2) &&
                      (z >= 0.0f) && (z < INFINITY) &&
                      (!ZLOW || z > zlo[j]);
      if (ok && (z < zbest[j] || (z == zbest[j] && id > wid[j]))) {
        zbest[j] = z;
        wid[j] = id;
      }
    }
  }
}

}  // namespace mtr

// The CTA layout above, {PARTS, WARP_W, WARP_H, K1_THREADS}, exported by
// each library built from this header (K1's, K2's and K3's): raster.py holds
// its own copy, which the pixel-layout twins use, against it.
extern "C" cudaError_t mtr_raster_layout(int* out) {
  out[0] = mtr::PARTS;
  out[1] = mtr::WARP_W;
  out[2] = mtr::WARP_H;
  out[3] = mtr::K1_THREADS;
  return cudaSuccess;
}
