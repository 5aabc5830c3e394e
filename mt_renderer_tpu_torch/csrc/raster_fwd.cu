// Binned single-layer tile raster with the tap or mtap epilogue, lit or
// unlit, for Hopper (sm_90a).
//
// Replaces the TPU kernel mt_renderer_tpu/render/pallas_raster.py::
// _raster_fwd_kernel (with _sl_group_body and the tap and mtap branches of
// _epilogue_rows, lit or unlit), on every path but zlow (the multipass
// peel's input, not ported by decision).
//
// What bounds it: the f32 work over binned (triangle, pixel) pairs (three
// edge functions and a depth plane each) would, but most of those pairs
// are provably empty: half the triangles are back-facing or clipped
// (REJECT bias) and a triangle's group bbox is far larger than the
// pixels it covers. So the design evaluates fewer pairs, and what is
// left is the latency of the chunk loads and the epilogue's writes.
//
// Design (the layout and group body are raster_group.cuh's, which the
// probe K3 runs too):
// - PARTS (4) CTAs of 64 threads per 16x128 tile, each owning a 16x32
//   part: two warps of 32x8 pixels, 8 per lane, the running (z, winner
//   id) pair in registers. Each CTA walks its tile's whole list, so a
//   heavy tile's arithmetic spreads over four SMs and no merge is needed.
//   (On an H100 at 700 W, four quarter-tile CTAs ran about 18% faster
//   than two half-tile ones and about 40% faster than one full-tile CTA;
//   PERF.md has the sweep.)
// - The tile's live (chunk, group) pairs (bit g of the group mask) form
//   one stream. Each pair's 15 raster columns (1,920 bytes) are copied
//   with cp.async into a RING-slot ring in shared memory, RING - 1 pairs
//   ahead of the pair being rastered; one barrier per pair (pair_ring.cuh,
//   shared with K2).
// - Each warp culls the group against its 32x8 rectangle exactly (one
//   triangle per lane, then a ballot) and evaluates only the survivors.
// - The epilogue (tap_epilogue.cuh, shared with K2) loads the winner's 18
//   (27 lit) coefficient columns by global id and evaluates the tap or
//   mtap planes; uncovered pixels evaluate zero coefficients, as the
//   reference does.
//
// Built with -fmad=false so every a*x + b*y + c rounds like the plain
// PyTorch version's separate ops (and the cull's corner evaluation like
// its plain twin's).

#include "pair_ring.cuh"

namespace {

using namespace mtr;

constexpr int RING = 12;                     // staged pairs in flight + 1

template <int MODE, bool LIT>
__global__ void __launch_bounds__(K1_THREADS)
raster_fwd_kernel(const float* __restrict__ cols, int tp,
                  const int* __restrict__ lists,
                  const int* __restrict__ glists,
                  const int* __restrict__ counts, int maxc, int n_tx,
                  int x0, int y0, float w_eps, Light light,
                  float* __restrict__ zb_out, int* __restrict__ ib_out,
                  float* __restrict__ attrs_out,
                  int* __restrict__ tapidx_out) {
  __shared__ __align__(16) float s_ring[RING][NRAST][KG];

  const int t = blockIdx.x / PARTS;
  const WarpPixels w = warp_pixels(blockIdx.x % PARTS,
                                   (float)((t % n_tx) * TILE_W + x0),
                                   (float)((t / n_tx) * TILE_H + y0));
  float zbest[K1_PPT];
  int wid[K1_PPT];
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) {
    zbest[j] = INFINITY;
    wid[j] = -1;
  }

  const int count = counts[t];
  const int* list = lists + (size_t)t * maxc;
  const int* gmasks = glists + (size_t)t * maxc;
  for_each_pair<NRAST, RING>(
      count, list, gmasks, cols, tp, s_ring,
      [&](const float (*st)[KG], int id0) {
        raster_group(st, id0, w, zbest, wid);
      });

  constexpr int NPLANES = MODE == TAP ? NTAP : NMTAP;
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) {
    const int p = w.p0 + j * TILE_W;
    const int id = wid[j];
    const size_t o = (size_t)t * P + p;
    zb_out[o] = id >= 0 ? zbest[j] : 1.0f;
    ib_out[o] = id;
    float* ta = attrs_out + (size_t)t * NPLANES * P + p;
    if constexpr (MODE == TAP)
      tap_epilogue<LIT>(cols, tp, id, w.px, w.py[j], w_eps, light, ta,
                        tapidx_out + o);
    else
      mtap_epilogue<LIT>(cols, tp, id, w.px, w.py[j], w_eps, light, ta);
  }
}

template <int MODE, bool LIT>
cudaError_t launch(const float* cols, int tp, const int* lists,
                   const int* glists, const int* counts, int n_tiles,
                   int maxc, int n_tx, int x0, int y0, float w_eps,
                   Light light, float* zb, int* ib, float* attrs,
                   int* tapidx, cudaStream_t stream) {
  raster_fwd_kernel<MODE, LIT><<<n_tiles * PARTS, K1_THREADS, 0, stream>>>(
      cols, tp, lists, glists, counts, maxc, n_tx, x0, y0, w_eps, light, zb,
      ib, attrs, tapidx);
  return cudaGetLastError();
}

}  // namespace

// cols (ncol >= 33, or 42 when lit, tp) f32 column-major per-triangle
// setup, 16-byte aligned; lists and glists (n_tiles, maxc) i32; counts
// (n_tiles,) i32; mode 0 = tap, 1 = mtap; lit != 0 folds the lambert
// factor of the unit light (lx, ly, lz) into C rgb. Outputs are
// tile-major: zb f32 and ib i32 (n_tiles, 2048), attrs f32 (n_tiles, 6
// or 17, 2048), tapidx i32 (n_tiles, 2048) in tap mode (unused, may be
// null, in mtap mode). Launches on ``stream`` and returns the launch
// status; does not synchronise.
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
      blocks, raster_fwd_kernel<TAP, false>, K1_THREADS, 0);
}
