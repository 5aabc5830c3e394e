// SWAR bilinear filter of quad-pool rows, gather fused, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel tools/bench/bilin_ab.py::_swar_kernel (wrapper
// run_swar_pl): the 2x2 bilinear contraction of a quad-pool row (texel,
// right, down, down-right, each RGBA8 in one u32) with 8-bit integer
// weights w = trunc(clip(f * 256 + 0.5, 0, 256)), two packed fields per
// 32-bit lane (0x00FF00FF / 0xFF00FF00 halves), round to nearest by
// +0x00800080 before the >> 8, and the packed RGBA8 result
// r | g << 8 | b << 16 | a << 24.
//
// What bounds it: memory. Per row it reads a 4-byte index, two 4-byte
// fractions and one 16-byte pool row, and writes 4 bytes; the integer
// work is some 30 operations. On the TPU the row gather was a separate
// XLA op ahead of the kernel; here it is fused: one 16-byte load per row
// (the probe scene's pool, 5,461 rows = 85 KiB, stays in cache).
//
// Integer arithmetic only, so it is bit-exact against its plain version.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned swar_lerp(unsigned t0, unsigned t1,
                                              unsigned w) {
  const unsigned m = 0x00FF00FFu;
  const unsigned rb =
      ((t0 & m) * (256u - w) + (t1 & m) * w + 0x00800080u) >> 8;
  const unsigned ga =
      (((t0 >> 8) & m) * (256u - w) + ((t1 >> 8) & m) * w + 0x00800080u) >>
      8;
  return (rb & m) | ((ga & m) << 8);
}

__device__ __forceinline__ unsigned weight8(float f) {
  return (unsigned)__float2int_rz(fminf(fmaxf(f * 256.0f + 0.5f, 0.0f),
                                        256.0f));
}

__global__ void bilin_swar_kernel(const uint4* __restrict__ pool, int npool,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ fx,
                                  const float* __restrict__ fy,
                                  unsigned* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint4 q = pool[min(max(idx[i], 0), npool - 1)];
    const unsigned wx = weight8(fx[i]);
    const unsigned wy = weight8(fy[i]);
    out[i] = swar_lerp(swar_lerp(q.x, q.y, wx), swar_lerp(q.z, q.w, wx), wy);
  }
}

}  // namespace

// pool (npool, 4) u32 quad rows, 16-byte aligned; idx (n,) i32 rows,
// clamped to [0, npool - 1]; fx, fy (n,) f32; out (n,) u32. Launches on
// ``stream`` and returns the launch status; does not synchronise.
extern "C" cudaError_t mtr_bilin_swar(const void* pool, int npool,
                                      const int* idx, const float* fx,
                                      const float* fy, unsigned* out,
                                      long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  bilin_swar_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)pool, npool, idx, fx, fy, out, n);
  return cudaGetLastError();
}
