// Binned single-layer tile raster with the bilinear-tap epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mt_renderer_tpu/render/pallas_raster.py::
// _raster_fwd_kernel (with _sl_group_body and the tap branch of
// _epilogue_rows), on its tap / unlit / no-zlow path.
//
// What bounds it: f32 ALU work over the binned (triangle, pixel) pairs:
// three edge functions and one depth plane per pair. The 1080p frame of
// the 196,608-triangle demo scene binds 4,520 live (tile, group) pairs
// after the group-mask skip, i.e. about 0.3 G (triangle, pixel) pairs
// (the count pallas_raster.py:62-67 gives for the same binning). Bytes
// are small next to that: each live 32-triangle group is 15 columns x
// 32 floats, read once per tile.
//
// Design, and all of it: one CTA per 16x128 tile, 256 threads, 8 pixels
// per thread with the running (z, winner id) pair in registers. For each
// chunk of the tile's list, the 15 raster columns of the live groups
// (bit g of the tile's group mask) are staged into shared memory with
// coalesced loads from the column-major (ncol, Tp) matrix; groups whose
// bit is clear are neither loaded nor evaluated. Every pixel keeps the
// lexicographic minimum of (z, -global id) over candidates that pass
// all three edge tests (e > bias) and 0 <= z < inf, which is the
// reference's group-min-then-update rule, so chunk order is invisible.
// The epilogue (tap_epilogue.cuh, shared with K2) loads the winner's 18
// coefficient columns by global id (no one-hot select) and evaluates the
// tap address, fx, fy and C rgba.
// Uncovered pixels evaluate zero coefficients, as the reference does:
// tapidx 0, fx = fy = 0, C = 0.
//
// Built with -fmad=false so every a*x + b*y + c rounds like the plain
// PyTorch version's separate ops. TMA, cp.async double buffering and
// warp specialisation are left for later work.

#include "tap_epilogue.cuh"

namespace {

using namespace mtr;

__global__ void __launch_bounds__(THREADS)
raster_fwd_kernel(const float* __restrict__ cols, int tp,
                  const int* __restrict__ lists,
                  const int* __restrict__ glists,
                  const int* __restrict__ counts, int maxc, int n_tx,
                  int x0, int y0, float w_eps,
                  float* __restrict__ zb_out, int* __restrict__ ib_out,
                  float* __restrict__ tattrs_out,
                  int* __restrict__ tapidx_out) {
  __shared__ float s_cols[NRAST][CT];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px0 = (float)((t % n_tx) * TILE_W + x0);
  const float py0 = (float)((t / n_tx) * TILE_H + y0);
  // pixel p = tid + j * THREADS of the flattened (TILE_H, TILE_W) tile
  const float px = (float)(tid % TILE_W) + (px0 + 0.5f);
  float py[PPT];
  float zbest[PPT];
  int wid[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    py[j] = (float)(tid / TILE_W + j * ROWS_PER_PASS) + (py0 + 0.5f);
    zbest[j] = INFINITY;
    wid[j] = -1;
  }

  const int count = counts[t];
  for (int s = 0; s < count; ++s) {
    const int cid = lists[t * maxc + s];
    const int gmask = glists[t * maxc + s];
    const float* chunk = cols + (size_t)cid * CT;
    for (int i = tid; i < NRAST * CT; i += THREADS) {
      const int c = i / CT;
      const int k = i - c * CT;
      if ((gmask >> (k / KG)) & 1) s_cols[c][k] = chunk[(size_t)c * tp + k];
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      if (!((gmask >> g) & 1)) continue;       // uniform over the CTA
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
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * THREADS;
    const int w = wid[j];
    const size_t o = (size_t)t * P + p;
    zb_out[o] = w >= 0 ? zbest[j] : 1.0f;
    ib_out[o] = w;
    tap_epilogue(cols, tp, w, px, py[j], w_eps,
                 tattrs_out + (size_t)t * NTAP * P + p, tapidx_out + o);
  }
}

}  // namespace

// cols (ncol >= 33, tp) f32 column-major per-triangle setup; lists and
// glists (n_tiles, maxc) i32; counts (n_tiles,) i32. Outputs are
// tile-major: zb f32 and ib i32 (n_tiles, 2048), tattrs f32
// (n_tiles, 6, 2048), tapidx i32 (n_tiles, 2048). Launches on
// ``stream`` and returns the launch status; does not synchronise.
extern "C" cudaError_t mtr_raster_fwd(
    const float* cols, int tp, const int* lists, const int* glists,
    const int* counts, int n_tiles, int maxc, int n_tx, int x0, int y0,
    float w_eps, float* zb, int* ib, float* tattrs, int* tapidx,
    void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  raster_fwd_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      cols, tp, lists, glists, counts, maxc, n_tx, x0, y0, w_eps, zb, ib,
      tattrs, tapidx);
  return cudaGetLastError();
}
