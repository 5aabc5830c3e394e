// Binned single-layer tile raster with the tap or mtap epilogue, lit or
// unlit, for Hopper (sm_90a).
//
// Replaces the TPU kernel mt_renderer_tpu/render/pallas_raster.py::
// _raster_fwd_kernel (with _sl_group_body and the tap and mtap branches of
// _epilogue_rows, lit or unlit), on every path but zlow (the multipass
// peel's input, not ported by decision).
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
// bit is clear are neither loaded nor evaluated. The group body is
// raster_group.cuh, which the speed-of-light probe K3 (raster_micro.cu)
// runs too. The epilogue (tap_epilogue.cuh, shared with K2) loads the
// winner's 18 (27 lit) coefficient columns by global id (no one-hot
// select) and evaluates the tap or mtap planes. Uncovered pixels evaluate
// zero coefficients, as the reference does.
//
// Built with -fmad=false so every a*x + b*y + c rounds like the plain
// PyTorch version's separate ops. TMA, cp.async double buffering and
// warp specialisation are left for later work.

#include "raster_group.cuh"

namespace {

using namespace mtr;

template <int MODE, bool LIT>
__global__ void __launch_bounds__(THREADS)
raster_fwd_kernel(const float* __restrict__ cols, int tp,
                  const int* __restrict__ lists,
                  const int* __restrict__ glists,
                  const int* __restrict__ counts, int maxc, int n_tx,
                  int x0, int y0, float w_eps, Light light,
                  float* __restrict__ zb_out, int* __restrict__ ib_out,
                  float* __restrict__ attrs_out,
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
      raster_group(s_cols, g, cid, px, py, zbest, wid);
    }
    __syncthreads();
  }

  constexpr int NPLANES = MODE == TAP ? NTAP : NMTAP;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * THREADS;
    const int w = wid[j];
    const size_t o = (size_t)t * P + p;
    zb_out[o] = w >= 0 ? zbest[j] : 1.0f;
    ib_out[o] = w;
    float* ta = attrs_out + (size_t)t * NPLANES * P + p;
    if constexpr (MODE == TAP)
      tap_epilogue<LIT>(cols, tp, w, px, py[j], w_eps, light, ta,
                        tapidx_out + o);
    else
      mtap_epilogue<LIT>(cols, tp, w, px, py[j], w_eps, light, ta);
  }
}

template <int MODE, bool LIT>
cudaError_t launch(const float* cols, int tp, const int* lists,
                   const int* glists, const int* counts, int n_tiles,
                   int maxc, int n_tx, int x0, int y0, float w_eps,
                   Light light, float* zb, int* ib, float* attrs,
                   int* tapidx, cudaStream_t stream) {
  raster_fwd_kernel<MODE, LIT><<<n_tiles, THREADS, 0, stream>>>(
      cols, tp, lists, glists, counts, maxc, n_tx, x0, y0, w_eps, light, zb,
      ib, attrs, tapidx);
  return cudaGetLastError();
}

}  // namespace

// cols (ncol >= 33, or 42 when lit, tp) f32 column-major per-triangle
// setup; lists and glists (n_tiles, maxc) i32; counts (n_tiles,) i32;
// mode 0 = tap, 1 = mtap; lit != 0 folds the lambert factor of the unit
// light (lx, ly, lz) into C rgb. Outputs are tile-major: zb f32 and ib
// i32 (n_tiles, 2048), attrs f32 (n_tiles, 6 or 17, 2048), tapidx i32
// (n_tiles, 2048) in tap mode (unused, may be null, in mtap mode).
// Launches on ``stream`` and returns the launch status; does not
// synchronise.
extern "C" cudaError_t mtr_raster_fwd(
    const float* cols, int tp, const int* lists, const int* glists,
    const int* counts, int n_tiles, int maxc, int n_tx, int x0, int y0,
    float w_eps, int mode, int lit, float lx, float ly, float lz,
    float* zb, int* ib, float* attrs, int* tapidx, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const Light light{lx, ly, lz};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == TAP && !lit)
    return launch<TAP, false>(cols, tp, lists, glists, counts, n_tiles, maxc,
                              n_tx, x0, y0, w_eps, light, zb, ib, attrs,
                              tapidx, s);
  if (mode == TAP)
    return launch<TAP, true>(cols, tp, lists, glists, counts, n_tiles, maxc,
                             n_tx, x0, y0, w_eps, light, zb, ib, attrs,
                             tapidx, s);
  if (mode == MTAP && !lit)
    return launch<MTAP, false>(cols, tp, lists, glists, counts, n_tiles,
                               maxc, n_tx, x0, y0, w_eps, light, zb, ib,
                               attrs, tapidx, s);
  if (mode == MTAP)
    return launch<MTAP, true>(cols, tp, lists, glists, counts, n_tiles,
                              maxc, n_tx, x0, y0, w_eps, light, zb, ib,
                              attrs, tapidx, s);
  return cudaErrorInvalidValue;
}

// CTAs of the unlit tap kernel (the headline's) that one SM holds at once:
// the occupancy at which the probe K3 fills the card.
extern "C" cudaError_t mtr_raster_fwd_blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, raster_fwd_kernel<TAP, false>, THREADS, 0);
}
