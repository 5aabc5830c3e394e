// Binned multi-layer (order-independent transparency) tile raster with
// the tap or mip-tap epilogue per layer, lit or unlit, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mt_renderer_tpu/render/pallas_raster.py::
// _raster_fwd_ml_kernel (wrapper raster_pallas_fwd_ml), variants "full"
// (opaque cull) and "nocull" with or without the zhi horizon, with the
// tap and mtap epilogues of _epilogue_rows, lit or unlit.
//
// What it computes. Per pixel, the L nearest fragments (L = 2..8) under
// the strict total order (z ascending, then global triangle id
// descending on exact ties) among the candidates that pass all three
// edge tests (e > bias), 0 <= z < inf, z <= zhi (when given) and, with
// the opaque cull, z <= the nearest opaque candidate's z. A row is
// opaque when its tex column is an integer (device.setup_packed_cols
// encodes translucency as a half-integer). With the cull, kept entries
// strictly behind the final opaque z are invalidated (id -1). Outputs,
// tile-major: zl (n_tiles, L, P) f32, 1.0 where the id is < 0; il
// (n_tiles, L, P) i32; in tap mode tattrs (n_tiles, 6L, P) f32, layer l's
// planes at rows 6l..6l+5, and tapidx (n_tiles, L, P) i32; in mtap mode
// mattrs (n_tiles, 17L, P) f32, layer l's planes at rows 17l..17l+16.
//
// Why per-candidate insertion equals the reference's per-group
// extraction. The reference extracts each group's L nearest candidates
// per pixel and inserts them into the list in that order; this kernel
// inserts every candidate as it comes, in chunk-list order. Inserting
// into an L-deep list sorted under a strict total order keeps the L
// smallest elements of whatever was offered, in any arrival order. The
// cull against the list's current deepest z only drops candidates that
// the insertion would reject anyway (L entries already precede them),
// and it uses <=, so a coincident candidate still reaches the id tie
// rule. The opaque cull is order-independent as well: let Z be the
// least z of the opaque candidates. Every candidate with z <= Z passes
// the opaque test whenever it comes, because the running opaque z only
// decreases and never goes below Z. Every candidate with z > Z ranks
// after all of those, so it can displace none of them. If such a
// candidate is still kept at the end, the list is not full of
// candidates with z <= Z, so the opaque candidate at Z passed the list
// test when it came and set the running opaque z to Z; the final strict
// z > Z test then invalidates the candidate. So the result is the first
// L candidates with z <= Z, the same as the reference's, whatever the
// order.
//
// The per-warp cull below skips only (triangle, warp) pairs none of
// whose candidates passes the edge tests, so no skipped candidate would
// have inserted anything or moved the opaque z: the lists, and the
// argument above, are those of the full evaluation.
//
// The TPU kernel's second pass (a re-sweep of the chunk list that
// recovers each layer's coefficients through a one-hot bf16x3 matrix
// select) exists only because the columns have left VMEM once the list
// reorders. Here the epilogue loads each kept id's 18 columns (27 lit)
// from the column-major (ncol, Tp) matrix, as K1 does; that is exact by
// construction. The epilogues are K1's (tap_epilogue.cuh), behind one
// non-inlined function that takes the mode and the lighting as runtime
// arguments, uniform over the grid: the branch and the call cost little
// per kept layer and pixel, the template count stays at L x cull x zhi
// (28 kernels), and the four epilogues are compiled once, not into each
// of the 28.
//
// What bounds it: the output bytes, L times K1's (about 300 MB at the
// glass headline, L = 4, tap). The arithmetic over binned (triangle,
// pixel) pairs would, but most of those pairs are provably empty, so
// the design evaluates fewer of them, as K1 does. What is left is the
// write phase (with every chunk count 0, about 1.3 times a plain fill
// of the same bytes on an H100; PERF.md) and the loop over the
// survivors.
//
// Design (K1's, with the lists added):
// - K1's CTA layout (raster_group.cuh): PARTS (4) CTAs of two warps per
//   16x128 tile, each a 16x32 quarter walking the tile's whole list (a
//   heavy tile spreads over four SMs, no merge); each warp owns a 32x8
//   block of pixels, each lane one column of it (8 pixels).
// - The tile's live (chunk, group) pairs stream through a cp.async ring
//   (pair_ring.cuh, shared with K1), RING - 1 pairs ahead, one barrier
//   per pair. With the opaque cull each slot also holds the tex column
//   (16 rows, 2,048 bytes), whose integer test marks opaque triangles.
//   (On an H100 at 700 W, rings of 2 to 12 slots ran within a few
//   percent of each other; the smaller the ring, the more CTAs an SM
//   holds. PERF.md has the sweep.)
// - Each warp culls each staged group before any pixel test with K1's
//   exact per-edge corner test (warp_cull: one triangle per lane, one
//   ballot) and evaluates only the survivors, in ascending k. (A per-warp
//   depth cull against the pixels' running limits was exact too, but
//   measured no faster; PERF.md has the readings.)
// - The (z, id) lists live in dynamic shared memory, layer-major
//   ([l][q], q = j * 64 + thread: a lane's pixel j, conflict-free across
//   a warp): L * 4 KiB a CTA. Each lane keeps in registers, per pixel,
//   the cull limit min(list's deepest z, zhi, opaque z) and min(zhi,
//   opaque z), so a rejected candidate never touches the list.
// - The writes go layer by layer, each layer's planes row by row. An
//   empty layer (id < 0) writes the zero coefficients' epilogue, the
//   same at every pixel and so computed once per thread; a kept one
//   calls the epilogue.
// L, the opaque cull and the presence of zhi are template parameters.
//
// Built with -fmad=false, like K1, so every plane evaluation rounds like
// the plain PyTorch version's separate ops, and the cull's corners like
// the pixels.

#include "pair_ring.cuh"

namespace {

using namespace mtr;

constexpr int CTA_P = K1_PPT * K1_THREADS;   // a CTA's pixels (512)

constexpr int RING = 4;                      // staged pairs in flight + 1

// The epilogue outputs of triangle id (or of zero coefficients, id < 0)
// at pixel (px, py): the mtap planes, or the tap planes and the quad-pool
// row, lit or not.
__device__ __noinline__ void layer_values(const float* __restrict__ cols,
                                          int tp, int id, float px, float py,
                                          float w_eps, int mode, int lit,
                                          Light light, Planes& o) {
  if (mode == MTAP) {
    if (lit)
      mtap_values<true>(cols, tp, id, px, py, w_eps, light, o);
    else
      mtap_values<false>(cols, tp, id, px, py, w_eps, light, o);
  } else if (lit) {
    tap_values<true>(cols, tp, id, px, py, w_eps, light, o);
  } else {
    tap_values<false>(cols, tp, id, px, py, w_eps, light, o);
  }
}

// Writes one kept layer's epilogue at pixel (px, py): the mtap planes, or
// the tap planes and the quad-pool row, lit or not, as K1 writes them.
__device__ __noinline__ void layer_epilogue(
    const float* __restrict__ cols, int tp, int id, float px, float py,
    float w_eps, int mode, int lit, Light light, float* __restrict__ attrs,
    int* __restrict__ tapidx) {
  if (mode == MTAP) {
    if (lit)
      mtap_epilogue<true>(cols, tp, id, px, py, w_eps, light, attrs);
    else
      mtap_epilogue<false>(cols, tp, id, px, py, w_eps, light, attrs);
  } else if (lit) {
    tap_epilogue<true>(cols, tp, id, px, py, w_eps, light, attrs, tapidx);
  } else {
    tap_epilogue<false>(cols, tp, id, px, py, w_eps, light, attrs, tapidx);
  }
}

template <int L, bool OPAQUE_CULL, bool HAS_ZHI>
__global__ void __launch_bounds__(K1_THREADS)
raster_fwd_ml_kernel(const float* __restrict__ cols, int tp,
                     const int* __restrict__ lists,
                     const int* __restrict__ glists,
                     const int* __restrict__ counts, int maxc, int n_tx,
                     int x0, int y0, float w_eps,
                     const float* __restrict__ zhi, int mode, int lit,
                     Light light, float* __restrict__ zl_out,
                     int* __restrict__ il_out,
                     float* __restrict__ attrs_out,
                     int* __restrict__ tapidx_out) {
  constexpr int ROWS = OPAQUE_CULL ? NRAST + 1 : NRAST;
  __shared__ __align__(16) float s_ring[RING][ROWS][KG];
  extern __shared__ float4 s_dyn[];            // L * CTA_P (z, id) pairs
  float* s_z = reinterpret_cast<float*>(s_dyn);
  int* s_id = reinterpret_cast<int*>(s_z + L * CTA_P);

  const int t = blockIdx.x / PARTS;
  const WarpPixels w = warp_pixels(blockIdx.x % PARTS,
                                   (float)((t % n_tx) * TILE_W + x0),
                                   (float)((t / n_tx) * TILE_H + y0));
  float zcap[K1_PPT];   // min(zhi, nearest opaque candidate so far)
  float zlim[K1_PPT];   // min(list's deepest z, zcap)
#pragma unroll
  for (int j = 0; j < K1_PPT; ++j) {
    const int q = j * K1_THREADS + threadIdx.x;    // the lane's own entries
    zcap[j] = HAS_ZHI ? zhi[(size_t)t * P + w.p0 + j * TILE_W] : INFINITY;
    zlim[j] = zcap[j];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      s_z[l * CTA_P + q] = INFINITY;
      s_id[l * CTA_P + q] = -1;
    }
  }

  const int count = counts[t];
  const int* list = lists + (size_t)t * maxc;
  const int* gmasks = glists + (size_t)t * maxc;
  for_each_pair<ROWS, RING>(
      count, list, gmasks, cols, tp, s_ring,
      [&](const float (*st)[KG], int id0) {
        unsigned live = warp_cull(st, w);
        while (live) {
          const int k = __ffs(live) - 1;
          live &= live - 1;
          const float ea0 = st[0][k], ea1 = st[1][k], ea2 = st[2][k];
          const float eb0 = st[3][k], eb1 = st[4][k], eb2 = st[5][k];
          const float ec0 = st[6][k], ec1 = st[7][k], ec2 = st[8][k];
          const float bi0 = st[9][k], bi1 = st[10][k], bi2 = st[11][k];
          const float za = st[12][k], zb = st[13][k], zc = st[14][k];
          bool opaque = false;
          if constexpr (OPAQUE_CULL) {
            const float tex = st[NRAST][k];
            opaque = tex == floorf(tex);
          }
          const int id = id0 + k;
          const float px = w.px;
#pragma unroll
          for (int j = 0; j < K1_PPT; ++j) {
            const float py = w.py[j];
            const float e0 = ea0 * px + eb0 * py + ec0;
            const float e1 = ea1 * px + eb1 * py + ec1;
            const float e2 = ea2 * px + eb2 * py + ec2;
            const float z = za * px + zb * py + zc;
            if (!((e0 > bi0) && (e1 > bi1) && (e2 > bi2) && (z >= 0.0f) &&
                  (z < INFINITY) && (z <= zlim[j])))
              continue;
            if (opaque) zcap[j] = z;               // z <= zlim <= zcap
            // insert (z, id): walk down the sorted list, swapping the
            // carried entry with every entry it precedes
            const int q = j * K1_THREADS + threadIdx.x;
            float zcar = z;
            int icar = id;
#pragma unroll
            for (int l = 0; l < L; ++l) {
              const float ze = s_z[l * CTA_P + q];
              const int ie = s_id[l * CTA_P + q];
              if (zcar < ze || (zcar == ze && icar > ie)) {
                s_z[l * CTA_P + q] = zcar;
                s_id[l * CTA_P + q] = icar;
                zcar = ze;
                icar = ie;
              }
            }
            zlim[j] = fminf(s_z[(L - 1) * CTA_P + q], zcap[j]);
          }
        }
      });

  // An empty layer (id < 0) writes the zero coefficients' epilogue, which
  // is the same at every pixel center (each plane of zero coefficients
  // evaluates to +0 at any finite x, y), so it is computed once.
  Planes empty;
  layer_values(cols, tp, -1, w.px, w.py[0], w_eps, mode, lit, light, empty);
  const int planes = mode == MTAP ? NMTAP : NTAP;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {         // a layer's planes, row by row
#pragma unroll
    for (int j = 0; j < K1_PPT; ++j) {
      const int p = w.p0 + j * TILE_W;
      const int q = j * K1_THREADS + threadIdx.x;
      const float z = s_z[l * CTA_P + q];
      int id = s_id[l * CTA_P + q];
      // entries strictly behind the nearest opaque fragment are invisible
      // under src-alpha compositing (every kept z is <= zhi, so z > zcap
      // is z > the opaque z)
      if (OPAQUE_CULL && z > zcap[j]) id = -1;
      const size_t o = ((size_t)t * L + l) * P + p;
      zl_out[o] = id >= 0 ? z : 1.0f;
      il_out[o] = id;
      float* ta = attrs_out + ((size_t)t * L + l) * planes * P + p;
      if (id >= 0) {
        layer_epilogue(cols, tp, id, w.px, w.py[j], w_eps, mode, lit, light,
                       ta, mode == MTAP ? nullptr : tapidx_out + o);
      } else {
#pragma unroll
        for (int c = 0; c < NMTAP; ++c)
          if (c < planes) ta[c * P] = empty.v[c];
        if (mode != MTAP) tapidx_out[o] = empty.tapidx;
      }
    }
  }
}

struct Args {
  const float* cols;
  int tp;
  const int* lists;
  const int* glists;
  const int* counts;
  int n_tiles, maxc, n_tx, x0, y0;
  float w_eps;
  const float* zhi;
  int mode, lit;
  Light light;
  float* zl;
  int* il;
  float* attrs;
  int* tapidx;
  cudaStream_t stream;
};

// One instantiation: its dynamic shared memory, launch and occupancy.
template <int L, bool OPAQUE_CULL, bool HAS_ZHI>
struct Instance {
  static constexpr int smem = L * CTA_P * (int)(sizeof(float) + sizeof(int));

  static cudaError_t prepare() {
    return cudaFuncSetAttribute(
        raster_fwd_ml_kernel<L, OPAQUE_CULL, HAS_ZHI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }

  static cudaError_t launch(const Args& a) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    raster_fwd_ml_kernel<L, OPAQUE_CULL, HAS_ZHI>
        <<<a.n_tiles * PARTS, K1_THREADS, smem, a.stream>>>(
            a.cols, a.tp, a.lists, a.glists, a.counts, a.maxc, a.n_tx, a.x0,
            a.y0, a.w_eps, a.zhi, a.mode, a.lit, a.light, a.zl, a.il,
            a.attrs, a.tapidx);
    return cudaGetLastError();
  }

  static cudaError_t blocks_per_sm(int* blocks) {
    cudaError_t err = prepare();
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, raster_fwd_ml_kernel<L, OPAQUE_CULL, HAS_ZHI>, K1_THREADS,
        smem);
  }
};

// Calls f(Instance<L, OPAQUE_CULL, HAS_ZHI>{}) for the runtime choice.
template <bool OPAQUE_CULL, bool HAS_ZHI, class F>
cudaError_t with_layers(int layers, F&& f) {
  switch (layers) {
    case 2: return f(Instance<2, OPAQUE_CULL, HAS_ZHI>{});
    case 3: return f(Instance<3, OPAQUE_CULL, HAS_ZHI>{});
    case 4: return f(Instance<4, OPAQUE_CULL, HAS_ZHI>{});
    case 5: return f(Instance<5, OPAQUE_CULL, HAS_ZHI>{});
    case 6: return f(Instance<6, OPAQUE_CULL, HAS_ZHI>{});
    case 7: return f(Instance<7, OPAQUE_CULL, HAS_ZHI>{});
    case 8: return f(Instance<8, OPAQUE_CULL, HAS_ZHI>{});
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t with_instance(int layers, int opaque_cull, bool has_zhi,
                          F&& f) {
  if (opaque_cull)
    return has_zhi ? with_layers<true, true>(layers, f)
                   : with_layers<true, false>(layers, f);
  return has_zhi ? with_layers<false, true>(layers, f)
                 : with_layers<false, false>(layers, f);
}

}  // namespace

// cols (ncol >= 33, or 42 when lit, tp) f32 column-major per-triangle
// setup, 16-byte aligned; lists and glists (n_tiles, maxc) i32; counts
// (n_tiles,) i32; zhi (n_tiles, 2048) f32 or null; mode 0 = tap, 1 =
// mtap; lit != 0 folds the lambert factor of the unit light (lx, ly, lz)
// into C rgb. Outputs are tile-major: zl f32 and il i32 (n_tiles, L,
// 2048); attrs f32 (n_tiles, 6L, 2048) in tap mode, (n_tiles, 17L, 2048)
// in mtap mode; tapidx i32 (n_tiles, L, 2048) in tap mode (unused, may be
// null, in mtap mode). Launches on ``stream`` and returns the launch
// status; does not synchronise.
extern "C" cudaError_t mtr_raster_fwd_ml(
    const float* cols, int tp, const int* lists, const int* glists,
    const int* counts, int n_tiles, int maxc, int n_tx, int x0, int y0,
    float w_eps, int layers, int opaque_cull, const float* zhi, int mode,
    int lit, float lx, float ly, float lz, float* zl, int* il, float* attrs,
    int* tapidx, void* stream) {
  if (n_tiles <= 0) return cudaSuccess;
  if (mode != TAP && mode != MTAP) return cudaErrorInvalidValue;
  const Args a{cols, tp, lists, glists, counts, n_tiles, maxc, n_tx, x0,
               y0, w_eps, zhi, mode, lit, Light{lx, ly, lz}, zl, il,
               attrs, tapidx, (cudaStream_t)stream};
  return with_instance(layers, opaque_cull, zhi != nullptr,
                       [&](auto k) { return decltype(k)::launch(a); });
}

// CTAs of the (layers, opaque_cull, has_zhi) instantiation that one SM
// holds at once.
extern "C" cudaError_t mtr_raster_fwd_ml_blocks_per_sm(int layers,
                                                       int opaque_cull,
                                                       int has_zhi,
                                                       int* blocks) {
  return with_instance(layers, opaque_cull, has_zhi != 0, [&](auto k) {
    return decltype(k)::blocks_per_sm(blocks);
  });
}
