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
// What bounds it: the same f32 ALU work over binned (triangle, pixel)
// pairs as K1 (three edge functions and one depth plane per pair),
// plus one insertion into the pixel's list, L compare-and-swaps in
// shared memory, per candidate that passes the culls.
//
// Design: one CTA per 16x128 tile, 256 threads, 8 pixels per thread, as
// in K1. The live groups' 15 raster columns (and, with the opaque cull,
// one opacity flag per triangle) are staged in shared memory; groups
// whose mask bit is clear are neither loaded nor evaluated. The (z, id)
// lists live in dynamic shared memory, layer-major ([l][p], conflict-free
// across a warp): L * 2048 * 8 bytes, 128 KiB at L = 8. Each thread keeps
// in registers, per pixel, the cull limit min(list's deepest z, zhi,
// opaque z), so the common rejected candidate never touches the list.
// L, the opaque cull and the presence of zhi are template parameters.
//
// Built with -fmad=false, like K1, so every plane evaluation rounds like
// the plain PyTorch version's separate ops. TMA, cp.async double
// buffering and warp specialisation are left for later work.

#include "tap_epilogue.cuh"

namespace {

using namespace mtr;

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
__global__ void __launch_bounds__(THREADS)
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
  __shared__ float s_cols[NRAST][CT];
  __shared__ bool s_opq[OPAQUE_CULL ? CT : 1];
  extern __shared__ float4 s_dyn[];            // L * P (z, id) pairs
  float* s_z = reinterpret_cast<float*>(s_dyn);
  int* s_id = reinterpret_cast<int*>(s_z + L * P);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const float px0 = (float)((t % n_tx) * TILE_W + x0);
  const float py0 = (float)((t / n_tx) * TILE_H + y0);
  // pixel p = tid + j * THREADS of the flattened (TILE_H, TILE_W) tile
  const float px = (float)(tid % TILE_W) + (px0 + 0.5f);
  float py[PPT];
  float zhi_r[PPT];     // caller's horizon (inf without zhi)
  float zop[PPT];       // nearest opaque candidate so far
  float zlim[PPT];      // min(list's deepest z, zhi, zop)
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * THREADS;
    py[j] = (float)(tid / TILE_W + j * ROWS_PER_PASS) + (py0 + 0.5f);
    zhi_r[j] = HAS_ZHI ? zhi[(size_t)t * P + p] : INFINITY;
    zop[j] = INFINITY;
    zlim[j] = zhi_r[j];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      s_z[l * P + p] = INFINITY;
      s_id[l * P + p] = -1;
    }
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
    if (OPAQUE_CULL) {
      for (int k = tid; k < CT; k += THREADS) {
        if ((gmask >> (k / KG)) & 1) {
          const float tex = chunk[(size_t)TEX_ROW * tp + k];
          s_opq[k] = tex == floorf(tex);
        }
      }
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
        const bool opaque = OPAQUE_CULL && s_opq[k];
        const int id = cid * CT + k;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float e0 = ea0 * px + eb0 * py[j] + ec0;
          const float e1 = ea1 * px + eb1 * py[j] + ec1;
          const float e2 = ea2 * px + eb2 * py[j] + ec2;
          const float z = za * px + zb * py[j] + zc;
          if (!((e0 > bi0) && (e1 > bi1) && (e2 > bi2) && (z >= 0.0f) &&
                (z < INFINITY) && (z <= zlim[j])))
            continue;
          if (opaque) zop[j] = z;                // z <= zlim <= zop
          // insert (z, id): walk down the sorted list, swapping the
          // carried entry with every entry it precedes
          const int p = tid + j * THREADS;
          float zcar = z;
          int icar = id;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            const float ze = s_z[l * P + p];
            const int ie = s_id[l * P + p];
            if (zcar < ze || (zcar == ze && icar > ie)) {
              s_z[l * P + p] = zcar;
              s_id[l * P + p] = icar;
              zcar = ze;
              icar = ie;
            }
          }
          zlim[j] = fminf(s_z[(L - 1) * P + p], fminf(zhi_r[j], zop[j]));
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * THREADS;
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      const float z = s_z[l * P + p];
      int id = s_id[l * P + p];
      // entries strictly behind the nearest opaque fragment are invisible
      // under src-alpha compositing
      if (OPAQUE_CULL && z > zop[j]) id = -1;
      const size_t o = ((size_t)t * L + l) * P + p;
      zl_out[o] = id >= 0 ? z : 1.0f;
      il_out[o] = id;
      const int planes = mode == MTAP ? NMTAP : NTAP;
      layer_epilogue(cols, tp, id, px, py[j], w_eps, mode, lit, light,
                     attrs_out + ((size_t)t * L + l) * planes * P + p,
                     mode == MTAP ? nullptr : tapidx_out + o);
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

template <int L, bool OPAQUE_CULL, bool HAS_ZHI>
cudaError_t launch(const Args& a) {
  constexpr int smem = L * P * (int)(sizeof(float) + sizeof(int));
  auto kernel = raster_fwd_ml_kernel<L, OPAQUE_CULL, HAS_ZHI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.n_tiles, THREADS, smem, a.stream>>>(
      a.cols, a.tp, a.lists, a.glists, a.counts, a.maxc, a.n_tx, a.x0,
      a.y0, a.w_eps, a.zhi, a.mode, a.lit, a.light, a.zl, a.il, a.attrs,
      a.tapidx);
  return cudaGetLastError();
}

template <bool OPAQUE_CULL, bool HAS_ZHI>
cudaError_t launch_layers(int layers, const Args& a) {
  switch (layers) {
    case 2: return launch<2, OPAQUE_CULL, HAS_ZHI>(a);
    case 3: return launch<3, OPAQUE_CULL, HAS_ZHI>(a);
    case 4: return launch<4, OPAQUE_CULL, HAS_ZHI>(a);
    case 5: return launch<5, OPAQUE_CULL, HAS_ZHI>(a);
    case 6: return launch<6, OPAQUE_CULL, HAS_ZHI>(a);
    case 7: return launch<7, OPAQUE_CULL, HAS_ZHI>(a);
    case 8: return launch<8, OPAQUE_CULL, HAS_ZHI>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cols (ncol >= 33, or 42 when lit, tp) f32 column-major per-triangle
// setup; lists and glists (n_tiles, maxc) i32; counts (n_tiles,) i32; zhi
// (n_tiles, 2048) f32 or null; mode 0 = tap, 1 = mtap; lit != 0 folds the
// lambert factor of the unit light (lx, ly, lz) into C rgb. Outputs are
// tile-major: zl f32 and il i32 (n_tiles, L, 2048); attrs f32 (n_tiles,
// 6L, 2048) in tap mode, (n_tiles, 17L, 2048) in mtap mode; tapidx i32
// (n_tiles, L, 2048) in tap mode (unused, may be null, in mtap mode).
// Launches on ``stream`` and returns the launch status; does not
// synchronise.
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
  if (opaque_cull)
    return zhi ? launch_layers<true, true>(layers, a)
               : launch_layers<true, false>(layers, a);
  return zhi ? launch_layers<false, true>(layers, a)
             : launch_layers<false, false>(layers, a);
}
