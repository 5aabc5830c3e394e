// Binned single-layer tile raster with the tap, mtap or attrs epilogue,
// lit or unlit, with or without a per-pixel zlow exclusion, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mt_renderer_tpu/render/pallas_raster.py::
// _raster_fwd_kernel whole: _sl_group_body with and without has_zlow, and
// the three branches of _epilogue_rows (tap, mtap, the plain attributes),
// lit or unlit. The zlow input and the attrs epilogue serve the multipass
// peel (device.render_frame_peeled(peel_mode="multipass")), which runs K1
// once per layer with the previous layer's depth as the exclusion.
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
//   (27 lit) coefficient columns by global id and evaluates the tap, mtap
//   or attrs planes; uncovered pixels evaluate zero coefficients, as the
//   reference does.
// - ZLOW (a template flag): each lane loads its pixels' zlow once, and the
//   per-pixel test also asks z > zlow (raster_group.cuh); the warp cull
//   does not read it. The flag off is the kernel without the input: the
//   instantiations of the tap and mtap paths compile the group body and
//   epilogues they compiled before zlow existed (only an unused pointer
//   parameter is new).
//
// Built with -fmad=false so every a*x + b*y + c rounds like the plain
// PyTorch version's separate ops (and the cull's corner evaluation like
// its plain twin's).

#include "pair_ring.cuh"

namespace {

using namespace mtr;

constexpr int RING = 12;                     // staged pairs in flight + 1

template <int MODE, bool LIT>
__host__ __device__ constexpr int n_planes() {
  return MODE == TAP ? NTAP
                     : (MODE == MTAP ? NMTAP : (LIT ? NATTRS_LIT : NATTRS));
}

template <int MODE, bool LIT, bool ZLOW>
__global__ void __launch_bounds__(K1_THREADS)
raster_fwd_kernel(const float* __restrict__ cols, int tp,
                  const int* __restrict__ lists,
                  const int* __restrict__ glists,
                  const int* __restrict__ counts, int maxc, int n_tx,
                  int x0, int y0, float w_eps, Light light,
                  const float* __restrict__ zlow,
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
  float zlo[K1_PPT];
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) {
    zbest[j] = INFINITY;
    wid[j] = -1;
    if constexpr (ZLOW) zlo[j] = zlow[(size_t)t * P + w.p0 + j * TILE_W];
  }

  const int count = counts[t];
  const int* list = lists + (size_t)t * maxc;
  const int* gmasks = glists + (size_t)t * maxc;
  for_each_pair<NRAST, RING>(
      count, list, gmasks, cols, tp, s_ring,
      [&](const float (*st)[KG], int id0) {
        raster_group<ZLOW>(st, id0, w, zbest, wid, zlo);
      });

  constexpr int NPLANES = n_planes<MODE, LIT>();
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
    else if constexpr (MODE == MTAP)
      mtap_epilogue<LIT>(cols, tp, id, w.px, w.py[j], w_eps, light, ta);
    else
      attrs_epilogue<LIT>(cols, tp, id, w.px, w.py[j], ta);
  }
}

// One launch's arguments, as mtr_raster_fwd receives them.
struct Args {
  const float* cols;
  int tp;
  const int* lists;
  const int* glists;
  const int* counts;
  int n_tiles, maxc, n_tx, x0, y0;
  float w_eps;
  Light light;
  const float* zlow;
  float* zb;
  int* ib;
  float* attrs;
  int* tapidx;
};

template <int MODE, bool LIT, bool ZLOW>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  raster_fwd_kernel<MODE, LIT, ZLOW>
      <<<a.n_tiles * PARTS, K1_THREADS, 0, stream>>>(
          a.cols, a.tp, a.lists, a.glists, a.counts, a.maxc, a.n_tx, a.x0,
          a.y0, a.w_eps, a.light, a.zlow, a.zb, a.ib, a.attrs, a.tapidx);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Args& a, bool lit, cudaStream_t s) {
  if (lit)
    return a.zlow ? launch<MODE, true, true>(a, s)
                  : launch<MODE, true, false>(a, s);
  return a.zlow ? launch<MODE, false, true>(a, s)
                : launch<MODE, false, false>(a, s);
}

}  // namespace

// cols (ncol >= 33, or 42 when lit, tp) f32 column-major per-triangle
// setup, 16-byte aligned; lists and glists (n_tiles, maxc) i32; counts
// (n_tiles,) i32; mode 0 = tap, 1 = mtap, 2 = attrs; lit != 0 reads the
// lit matrix (tap and mtap fold the lambert factor of the unit light (lx,
// ly, lz) into C rgb; attrs emits the normal planes); zlow, null or
// (n_tiles, 2048) f32 tile-major, admits at a pixel only z > zlow.
// Outputs are tile-major: zb f32 and ib i32 (n_tiles, 2048), attrs f32
// (n_tiles, 6, 17, 18 or 21, 2048), tapidx i32 (n_tiles, 2048) in tap
// mode (unused, may be null, otherwise). Launches on ``stream`` and
// returns the launch status; does not synchronise.
extern "C" cudaError_t mtr_raster_fwd(
    const float* cols, int tp, const int* lists, const int* glists,
    const int* counts, int n_tiles, int maxc, int n_tx, int x0, int y0,
    float w_eps, int mode, int lit, float lx, float ly, float lz,
    const float* zlow, float* zb, int* ib, float* attrs, int* tapidx,
    void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  const Args a{cols, tp, lists, glists, counts, n_tiles, maxc, n_tx, x0, y0,
               w_eps, Light{lx, ly, lz}, zlow, zb, ib, attrs, tapidx};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == TAP) return launch_mode<TAP>(a, lit != 0, s);
  if (mode == MTAP) return launch_mode<MTAP>(a, lit != 0, s);
  if (mode == ATTRS) return launch_mode<ATTRS>(a, lit != 0, s);
  return cudaErrorInvalidValue;
}

// CTAs of the unlit tap kernel (the headline's) that one SM holds at once:
// the occupancy at which the probe K3 fills the card.
extern "C" cudaError_t mtr_raster_fwd_blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, raster_fwd_kernel<TAP, false, false>, K1_THREADS, 0);
}
