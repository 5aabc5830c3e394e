// The cp.async ring that streams a tile's live (chunk, group) pairs into
// shared memory, shared by the raster kernels K1 (raster_fwd.cu) and K2
// (raster_fwd_ml.cu), which run it in raster_group.cuh's CTA layout.
//
// A tile's pairs are its list slots in order, and within a slot the
// groups whose mask bit is set, ascending. Each pair is ROWS rows of KG
// floats: the 15 raster columns and, when ROWS is 16, the tex column
// (TEX_ROW), from which K2's opaque cull reads each triangle's opacity.
// for_each_pair keeps RING - 1 pairs in flight ahead of the one being
// rastered, with one barrier per pair: after it, the pair has landed for
// every thread and the slot the previous pair used is free to refill.

#pragma once

#include "raster_group.cuh"

namespace mtr {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Walks a tile's live (list slot, group) pairs in list order, ascending
// groups within a slot. Every thread of the CTA walks the same pairs.
struct PairCursor {
  int s = -1;
  unsigned m = 0;

  __device__ __forceinline__ bool next(int count,
                                       const int* __restrict__ gmasks,
                                       int& slot, int& g) {
    while (m == 0) {
      if (++s >= count) {
        s = count;
        return false;
      }
      m = (unsigned)__ldg(gmasks + s) & GROUP_BITS;
    }
    g = __ffs(m) - 1;
    m &= m - 1;
    slot = s;
    return true;
  }
};

// Starts the copy of the cursor's next pair into `dst`, if there is one.
template <int ROWS>
__device__ __forceinline__ void stage_next(
    PairCursor& cur, int count, const int* __restrict__ list,
    const int* __restrict__ gmasks, const float* __restrict__ cols, int tp,
    float (*dst)[KG]) {
  static_assert(ROWS == NRAST || ROWS == NRAST + 1, "raster rows [+ tex]");
  int s, g;
  if (!cur.next(count, gmasks, s, g)) return;
  const float* src = cols + (size_t)__ldg(list + s) * CT + g * KG;
  for (int i = threadIdx.x; i < ROWS * KG / 4; i += K1_THREADS) {
    const int r = i / (KG / 4);
    const int q = i % (KG / 4);
    const int row = (ROWS == NRAST || r < NRAST) ? r : TEX_ROW;
    cp_async16(&dst[r][4 * q], src + (size_t)row * tp + 4 * q);
  }
}

// Calls body(st, id0) on each of the tile's live pairs in order: st the
// staged [ROWS][KG] group, id0 the global id of its triangle 0. The body
// is uniform over the CTA's threads between barriers; it must not write
// the ring.
template <int ROWS, int RING, class Body>
__device__ __forceinline__ void for_each_pair(
    int count, const int* __restrict__ list, const int* __restrict__ gmasks,
    const float* __restrict__ cols, int tp, float (*ring)[ROWS][KG],
    Body&& body) {
  PairCursor prod, cons;
  for (int i = 0; i < RING - 1; ++i) {
    stage_next<ROWS>(prod, count, list, gmasks, cols, tp, ring[i]);
    cp_async_commit();
  }
  for (int i = 0;; ++i) {
    int s, g;
    if (!cons.next(count, gmasks, s, g)) break;     // uniform over the CTA
    cp_async_wait<RING - 2>();                       // pair i has landed
    __syncthreads();                                 // ... for every thread,
                                                     // and pair i - 1's slot
                                                     // is free
    stage_next<ROWS>(prod, count, list, gmasks, cols, tp,
                     ring[(i + RING - 1) % RING]);
    cp_async_commit();
    body(ring[i % RING], __ldg(list + s) * CT + g * KG);
  }
  cp_async_wait<0>();
}

}  // namespace mtr
