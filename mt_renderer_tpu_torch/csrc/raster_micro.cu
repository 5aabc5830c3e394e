// Speed-of-light probe of the single-layer raster K1, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench/raster_roofline.py::_micro_kernel
// (wrapper _micro): K1's group body on one resident chunk, ``reps`` x 12
// groups, with no chunk loads, group gates or binning.
//
// What bounds it: the same work as K1's loop (raster_group.cuh, the very
// code K1 runs, in K1's CTA layout): per (group, warp) one exact cull
// test, then per surviving (triangle, warp) three edge functions and a
// depth plane at each of the warp's 256 pixels. Nothing else is in the
// loop. On a chunk that covers none of the probe's tile it times the
// cull tests alone; on one that covers it, the tests plus the survivors'
// evaluation. tools/raster_roofline.py turns the two into K1's rates.
//
// Design: the chunk's 15 raster columns are staged in shared memory once,
// as 12 groups in K1's staged layout; then each CTA runs reps x 12 groups
// ungated over its part of one 16x128 tile whose pixel centers are
// tile-local (p % 128 + 0.5, p / 128 + 0.5), passing rep * 384 + g * 32
// as the group's first id, so exact-z ties go to the later rep, as in
// the reference. One TPU core is the whole chip, but one CTA is a sliver
// of the card, so ``rows`` identical output rows are computed, each by
// K1's PARTS CTAs: launched at K1's occupancy they load the card as K1
// does. The winner's n_coef coefficient columns are loaded by id at the
// end, as K1's epilogue does.
//
// Built with -fmad=false, like K1.

#include "raster_group.cuh"

namespace {

using namespace mtr;

__global__ void __launch_bounds__(K1_THREADS)
raster_micro_kernel(const float* __restrict__ cols, int tp, int reps,
                    int n_coef, float* __restrict__ z_out,
                    int* __restrict__ id_out, float* __restrict__ coef_out) {
  __shared__ float s_grp[G][NRAST][KG];

  for (int i = threadIdx.x; i < NRAST * CT; i += K1_THREADS) {
    const int c = i / CT;
    const int k = i - c * CT;
    s_grp[k / KG][c][k % KG] = cols[(size_t)c * tp + k];
  }
  __syncthreads();

  const WarpPixels w = warp_pixels(blockIdx.x % PARTS, 0.0f, 0.0f);
  float zbest[K1_PPT];
  int wid[K1_PPT];
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) {
    zbest[j] = INFINITY;
    wid[j] = -1;
  }
  for (int r = 0; r < reps; ++r)
    for (int g = 0; g < G; ++g)
      raster_group(s_grp[g], r * CT + g * KG, w, zbest, wid);

  const size_t row = blockIdx.x / PARTS;
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) {
    const int p = w.p0 + j * TILE_W;
    const int id = wid[j];
    z_out[row * P + p] = zbest[j];
    id_out[row * P + p] = id;
    const int k = id >= 0 ? id % CT : 0;
    for (int i = 0; i < n_coef; ++i)
      coef_out[(row * n_coef + i) * P + p] =
          id >= 0 ? cols[(size_t)(NRAST + i) * tp + k] : 0.0f;
  }
}

}  // namespace

// cols (15 + n_coef, tp >= 384) f32 column-major: one chunk's setup, its
// triangle k in column k. Outputs (rows identical rows, each from PARTS
// CTAs): z f32 (rows, 2048) with +inf where uncovered, id i32 (rows,
// 2048) or -1, coef f32 (rows, n_coef, 2048), zero where uncovered.
// Launches on ``stream`` and returns the launch status; does not
// synchronise.
extern "C" cudaError_t mtr_raster_micro(const float* cols, int tp, int reps,
                                        int n_coef, int rows, float* z,
                                        int* id, float* coef, void* stream) {
  if (rows <= 0) return cudaSuccess;
  raster_micro_kernel<<<rows * PARTS, K1_THREADS, 0, (cudaStream_t)stream>>>(
      cols, tp, reps, n_coef, z, id, coef);
  return cudaGetLastError();
}
