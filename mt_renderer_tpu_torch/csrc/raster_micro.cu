// Speed-of-light probe of the single-layer raster K1, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/bench/raster_roofline.py::_micro_kernel
// (wrapper _micro): K1's group body on one resident chunk, ``reps`` x 12
// groups, with no chunk loads, group gates or binning. Its rate per
// (group, tile) pair is the ceiling K1's binned work is held against.
//
// What bounds it: the same f32 ALU work as K1 (three edge functions and a
// depth plane per (triangle, pixel) pair, raster_group.cuh, the very code
// K1 runs); nothing else is in the loop.
//
// Design: the chunk's 15 raster columns are staged in shared memory once;
// then each CTA runs reps x 12 groups ungated over one 16x128 tile whose
// pixel centers are tile-local (p % 128 + 0.5, p / 128 + 0.5), passing
// the loop index as the chunk id, so the ids are rep * 384 + k and exact-z
// ties go to the later rep, as in the reference. One TPU core is the whole
// chip, but one CTA is a sliver of the card, so ``ctas`` identical CTAs
// run, each writing its own output row (all rows equal): launched at K1's
// occupancy they load the card as K1 does. The winner's n_coef coefficient
// columns are loaded by id at the end, as K1's epilogue does.
//
// Built with -fmad=false, like K1.

#include "raster_group.cuh"

namespace {

using namespace mtr;

__global__ void __launch_bounds__(THREADS)
raster_micro_kernel(const float* __restrict__ cols, int tp, int reps,
                    int n_coef, float* __restrict__ z_out,
                    int* __restrict__ id_out, float* __restrict__ coef_out) {
  __shared__ float s_cols[NRAST][CT];

  const int tid = threadIdx.x;
  for (int i = tid; i < NRAST * CT; i += THREADS) {
    const int c = i / CT;
    const int k = i - c * CT;
    s_cols[c][k] = cols[(size_t)c * tp + k];
  }
  __syncthreads();

  const float px = (float)(tid % TILE_W) + 0.5f;
  float py[PPT];
  float zbest[PPT];
  int wid[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    py[j] = (float)(tid / TILE_W + j * ROWS_PER_PASS) + 0.5f;
    zbest[j] = INFINITY;
    wid[j] = -1;
  }
  for (int r = 0; r < reps; ++r)
    for (int g = 0; g < G; ++g)
      raster_group(s_cols, g, r, px, py, zbest, wid);

  const size_t row = blockIdx.x;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * THREADS;
    const int w = wid[j];
    z_out[row * P + p] = zbest[j];
    id_out[row * P + p] = w;
    const int k = w >= 0 ? w % CT : 0;
    for (int i = 0; i < n_coef; ++i)
      coef_out[(row * n_coef + i) * P + p] =
          w >= 0 ? cols[(size_t)(NRAST + i) * tp + k] : 0.0f;
  }
}

}  // namespace

// cols (15 + n_coef, tp >= 384) f32 column-major: one chunk's setup, its
// triangle k in column k. Outputs (ctas rows): z f32 (ctas, 2048) with
// +inf where uncovered, id i32 (ctas, 2048) or -1, coef f32
// (ctas, n_coef, 2048), zero where uncovered. Launches on ``stream`` and
// returns the launch status; does not synchronise.
extern "C" cudaError_t mtr_raster_micro(const float* cols, int tp, int reps,
                                        int n_coef, int ctas, float* z,
                                        int* id, float* coef, void* stream) {
  if (ctas <= 0) return cudaSuccess;
  raster_micro_kernel<<<ctas, THREADS, 0, (cudaStream_t)stream>>>(
      cols, tp, reps, n_coef, z, id, coef);
  return cudaGetLastError();
}
