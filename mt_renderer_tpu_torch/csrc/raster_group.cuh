// One culling group's single-layer raster work, shared by the production
// raster K1 (raster_fwd.cu) and its speed-of-light probe K3
// (raster_micro.cu), so that the probe prices the exact op mix of the
// production kernel. The counterpart of _sl_group_body
// (mt_renderer_tpu/render/pallas_raster.py:532), which the TPU kernels
// share the same way; the one-hot coefficient select of that body is
// gone: the kernels load the winner's columns by id in their epilogues.

#pragma once

#include "tap_epilogue.cuh"

namespace mtr {

// Group g of the chunk staged in s_cols (its 15 raster columns, chunk-
// local triangle k in column k), chunk id cid, against the thread's PPT
// pixels at (px, py[j]). Every pixel keeps the lexicographic minimum of
// (z, -global id) over the candidates inside all three edges (e > bias)
// with 0 <= z < inf: the reference's group-min-then-update rule, so the
// order of groups and chunks is invisible.
__device__ __forceinline__ void raster_group(
    float (*__restrict__ s_cols)[CT], int g, int cid, float px,
    const float (&py)[PPT], float (&zbest)[PPT], int (&wid)[PPT]) {
  for (int kk = 0; kk < KG; ++kk) {
    const int k = g * KG + kk;
    const float ea0 = s_cols[0][k], ea1 = s_cols[1][k], ea2 = s_cols[2][k];
    const float eb0 = s_cols[3][k], eb1 = s_cols[4][k], eb2 = s_cols[5][k];
    const float ec0 = s_cols[6][k], ec1 = s_cols[7][k], ec2 = s_cols[8][k];
    const float bi0 = s_cols[9][k], bi1 = s_cols[10][k], bi2 = s_cols[11][k];
    const float za = s_cols[12][k], zb = s_cols[13][k], zc = s_cols[14][k];
    const int id = cid * CT + k;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float e0 = ea0 * px + eb0 * py[j] + ec0;
      const float e1 = ea1 * px + eb1 * py[j] + ec1;
      const float e2 = ea2 * px + eb2 * py[j] + ec2;
      const float z = za * px + zb * py[j] + zc;
      const bool ok = (e0 > bi0) && (e1 > bi1) && (e2 > bi2) &&
                      (z >= 0.0f) && (z < INFINITY);
      if (ok && (z < zbest[j] || (z == zbest[j] && id > wid[j]))) {
        zbest[j] = z;
        wid[j] = id;
      }
    }
  }
}

}  // namespace mtr
