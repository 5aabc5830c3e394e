// Trilinear sample of the bc7 texel pool, the eight texels of each tap
// decoded in registers, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes BC7 at sample time with
// jnp ops (mt_renderer_tpu/render/device.py::_bc7_trilinear_fused over
// render/bcn.py::bc7_texel_device), as the port's plain twin does with
// torch ops (render/device.py::bc7_trilinear_reference). The twin
// evaluates every listed mode for every texel in int64 tensors and keeps
// the block's mode with a select; on the card those ops were most of a
// BC7 world's frame. This kernel is that twin's function, one thread a
// tap.
//
// What bounds it: bytes. A tap reads 24 B of inputs (off0, th, tw, lod,
// u, v), its 128 B pool row (eight 16 B BC7 blocks: the 2x2 group of
// its level-m0 footprint and the 2x2 parent group of its level-m1 one)
// and, where a decoded block's mode is partitioned, that block's 8 B of
// the 64 B hint row; it writes 16 B: about 232 B a tap at most, and
// neighbouring taps share rows. Decoding one texel by its block's mode
// is some 100-200 integer instructions.
//
// Design:
// - Threads in the order of the inputs: the compacted rows' tile-major
//   order, so neighbouring threads are neighbouring pixels of a segment
//   and mostly read the same rows (one DRAM read, then L1 and L2).
// - The level pair, the level-m0 block-row offset, both footprints and
//   their blocks' places in the row's two groups are computed as the
//   twin computes them (_levels, _mip_arith_bc1, _footprint and
//   _bc7_trilinear_fused).
// - Each texel loads its block (one 16 B load) and decodes it by its own
//   mode alone: the mode from the lowest set bit of byte 0, then a
//   per-mode decode (a template over the mode, so every field's place
//   and width is a compile-time constant) in 32-bit registers, with
//   funnel shifts for fields that cross a word. A partitioned block
//   (modes 0-3, 7) takes its texel's subset and its anchors from its
//   8 B of the hint row, as the twin does. A block of a mode not in
//   the scene's list (``modes``, a bit mask), or with byte 0 zero,
//   decodes to zeros, as in the twin. Weight tables sit in __constant__;
//   nothing is written to device memory but the output.
// - Where the tap's two levels are one (the texture's last level), the
//   parent group is not decoded: the twin selects the level-m0 sample.
//
// Built with -fmad=false: the float steps (the tap address, the
// contraction's weights and its sum order, the level select and the
// lerp a * (1 - fm) + b * fm) round as the twin's separate ops, and the
// decoded integers are the twin's, so the output is bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr unsigned PARTITIONED = 0x8Fu;      // modes 0-3 and 7

__constant__ unsigned char kWeight2[4] = {0, 21, 43, 64};
__constant__ unsigned char kWeight3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
__constant__ unsigned char kWeight4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                                           34, 38, 43, 47, 51, 55, 60, 64};

// A mode's fields (render/bcn.py _MODES): subsets, partition bits,
// rotation bits, index-selector bits, colour and alpha endpoint bits,
// p-bits (shared by a subset's two endpoints or not), index bits and
// second index bits.
template <int NSUB, int PB, int ROT, int ISB, int CB, int AB, int NPB,
          bool SHARED, int IB, int IB2>
struct Fields {
  static constexpr int nsub = NSUB, pb = PB, rot = ROT, isb = ISB, cb = CB,
                       ab = AB, npb = NPB, ib = IB, ib2 = IB2;
  static constexpr bool shared = SHARED;
};

template <int M> struct Mode;
template <> struct Mode<0> : Fields<3, 4, 0, 0, 4, 0, 6, false, 3, 0> {};
template <> struct Mode<1> : Fields<2, 6, 0, 0, 6, 0, 2, true, 3, 0> {};
template <> struct Mode<2> : Fields<3, 6, 0, 0, 5, 0, 0, false, 2, 0> {};
template <> struct Mode<3> : Fields<2, 6, 0, 0, 7, 0, 4, false, 2, 0> {};
template <> struct Mode<4> : Fields<1, 0, 2, 1, 5, 6, 0, false, 2, 3> {};
template <> struct Mode<5> : Fields<1, 0, 2, 0, 7, 8, 0, false, 2, 2> {};
template <> struct Mode<6> : Fields<1, 0, 0, 0, 7, 7, 2, false, 4, 0> {};
template <> struct Mode<7> : Fields<2, 6, 0, 0, 5, 5, 4, false, 2, 0> {};

__device__ __forceinline__ unsigned word(const uint4& b, int i) {
  return i == 0 ? b.x : i == 1 ? b.y : i == 2 ? b.z : b.w;
}

// ``count`` (at most 8) bits from bit ``start`` of the block's 128.
__device__ __forceinline__ unsigned bits(const uint4& b, int start,
                                         int count) {
  const int wi = start >> 5;
  const unsigned lo = word(b, wi), hi = word(b, wi < 3 ? wi + 1 : 3);
  return __funnelshift_r(lo, hi, start & 31) & ((1u << count) - 1u);
}

// An endpoint channel of ``n`` bits (and its p-bit) widened to 8 bits.
__device__ __forceinline__ int unquant(unsigned ep, int n) {
  ep <<= 8 - n;
  return (int)(ep | (ep >> n));
}

__device__ __forceinline__ int weight(int ib, unsigned idx) {
  return ib == 2 ? kWeight2[idx] : ib == 3 ? kWeight3[idx] : kWeight4[idx];
}

// Texel ``t`` of block ``b`` of mode ``M`` → out[4] (r, g, b, a): the
// integer arithmetic of bcn.bc7_texel_device for one mode. ``hs`` and
// ``ha`` are the block's hint words (subset ids, anchors); only the
// partitioned modes read them.
template <int M>
__device__ __forceinline__ void decode(const uint4& b, unsigned hs,
                                       unsigned ha, int t, int out[4]) {
  using F = Mode<M>;
  constexpr int neps = 2 * F::nsub;
  constexpr int nchan = F::ab ? 4 : 3;
  int pos = M + 1;
  pos += F::pb;                               // the partition: in the hint
  const unsigned rot = bits(b, pos, F::rot);
  pos += F::rot;
  const unsigned isel = bits(b, pos, F::isb);
  pos += F::isb;
  unsigned raw[4][6];
#pragma unroll
  for (int c = 0; c < nchan; ++c) {
#pragma unroll
    for (int e = 0; e < neps; ++e) {
      raw[c][e] = bits(b, pos, c < 3 ? F::cb : F::ab);
      pos += c < 3 ? F::cb : F::ab;
    }
  }
  unsigned pv[6];
#pragma unroll
  for (int i = 0; i < F::npb; ++i) {
    pv[i] = bits(b, pos, 1);
    pos += 1;
  }

  // this texel's subset, and its index bits' place: every texel before
  // it holds ib bits, one less for each anchor before it (texel 0 too)
  unsigned subset = 0;
  int off = F::ib * t - (t > 0);
  bool anchor = t == 0;
  if constexpr (F::nsub > 1) {
    subset = (hs >> (2 * t)) & 3u;
    const int a1 = ha & 0xFF;
    off -= a1 < t;
    anchor = anchor || t == a1;
    if constexpr (F::nsub == 3) {
      const int a2 = (ha >> 8) & 0xFF;
      off -= a2 < t;
      anchor = anchor || t == a2;
    }
  }
  const unsigned idx1 = bits(b, pos + off, F::ib - anchor);
  unsigned idx2 = 0;
  if constexpr (F::ib2 > 0) {
    const int pos2 = pos + 16 * F::ib - F::nsub;
    idx2 = bits(b, pos2 + F::ib2 * t - (t > 0), F::ib2 - (t == 0));
  }

  int ep[2][4];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= nchan) {
        ep[k][c] = 255;
        continue;
      }
      const int n = c < 3 ? F::cb : F::ab;
      int v[3];
#pragma unroll
      for (int s = 0; s < F::nsub; ++s) {
        const int e = 2 * s + k;
        if constexpr (F::npb > 0) {
          v[s] = unquant((raw[c][e] << 1) | pv[F::shared ? e / 2 : e], n + 1);
        } else {
          v[s] = unquant(raw[c][e], n);
        }
      }
      if constexpr (F::nsub == 1) {
        ep[k][c] = v[0];
      } else if constexpr (F::nsub == 2) {
        ep[k][c] = subset == 0 ? v[0] : v[1];
      } else {
        ep[k][c] = subset == 0 ? v[0] : subset == 1 ? v[1] : v[2];
      }
    }
  }

  int wc, wa;
  if constexpr (M == 4) {
    const int w1 = weight(2, idx1), w2 = weight(3, idx2);
    wc = isel == 0 ? w1 : w2;
    wa = isel == 0 ? w2 : w1;
  } else if constexpr (M == 5) {
    wc = weight(2, idx1);
    wa = weight(2, idx2);
  } else {
    wc = weight(F::ib, idx1);
    wa = wc;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int w = c < 3 ? wc : wa;
    out[c] = (ep[0][c] * (64 - w) + ep[1][c] * w + 32) >> 6;
  }
  if constexpr (F::rot > 0) {
    const int a = out[3];
    if (rot == 1) {
      out[3] = out[0];
      out[0] = a;
    } else if (rot == 2) {
      out[3] = out[1];
      out[1] = a;
    } else if (rot == 3) {
      out[3] = out[2];
      out[2] = a;
    }
  }
}

// Texel ``t`` of block ``blk`` of a pool row (and its hint row) → out[4].
__device__ __forceinline__ void texel(const uint4* __restrict__ row,
                                      const uint2* __restrict__ hrow,
                                      int blk, int t, unsigned modes,
                                      int out[4]) {
  const uint4 b = __ldg(row + blk);
  const int mode = __ffs(b.x & 0xFFu) - 1;
  if (mode < 0 || !((modes >> mode) & 1u)) {
    out[0] = out[1] = out[2] = out[3] = 0;
    return;
  }
  unsigned hs = 0, ha = 0;
  if ((PARTITIONED >> mode) & 1u) {
    const uint2 h = __ldg(hrow + blk);
    hs = h.x;
    ha = h.y;
  }
  switch (mode) {
    case 0: decode<0>(b, hs, ha, t, out); break;
    case 1: decode<1>(b, hs, ha, t, out); break;
    case 2: decode<2>(b, hs, ha, t, out); break;
    case 3: decode<3>(b, hs, ha, t, out); break;
    case 4: decode<4>(b, hs, ha, t, out); break;
    case 5: decode<5>(b, hs, ha, t, out); break;
    case 6: decode<6>(b, hs, ha, t, out); break;
    default: decode<7>(b, hs, ha, t, out); break;
  }
}

// A bilinear tap of a (hm, wm) level at (u, v): the clamped footprint
// and its fractions (device.py _tap_address and _footprint).
struct Tap {
  int x0, y0, x1, y1;
  float fx, fy;
};

__device__ __forceinline__ Tap footprint(int wm, int hm, float u, float v) {
  const float x = u * (float)wm - 0.5f;
  const float y = v * (float)hm - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const int wl = max(wm - 1, 0), hl = max(hm - 1, 0);
  Tap p;
  p.fx = x0 < 0.0f ? 0.0f : x - x0;
  p.fy = y0 < 0.0f ? 0.0f : y - y0;
  p.x0 = min(max(__float2int_rz(x0), 0), wl);
  p.y0 = min(max(__float2int_rz(y0), 0), hl);
  p.x1 = min(p.x0 + 1, wl);
  p.y1 = min(p.y0 + 1, hl);
  return p;
}

__device__ __forceinline__ int clamp01(int x) { return min(max(x, 0), 1); }

__global__ void __launch_bounds__(256) bc7_trilinear_kernel(
    const uint4* __restrict__ pool, long long npool,
    const uint2* __restrict__ aux, long long naux, unsigned modes,
    const int* __restrict__ off0, const int* __restrict__ th,
    const int* __restrict__ tw, const float* __restrict__ lod,
    const float* __restrict__ uu, const float* __restrict__ vv,
    float* __restrict__ out, long long n, int num_mips) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int h = th[i], w = tw[i];
  const float u = uu[i], v = vv[i];

  // the two levels (device.py _levels)
  const int big = max(h, w);
  int mmax = 0;
  for (int m = 1; m < num_mips; ++m) {
    if ((big >> m) > 0) mmax = m;
  }
  const float top = (float)(num_mips - 1);
  float l = lod[i];
  l = l < 0.0f ? 0.0f : l;                   // NaN stays NaN, as in clamp
  l = l > top ? top : l;
  const float m0f = floorf(l);
  const float fm = l - m0f;
  const int m0 = min(__float2int_rz(m0f), mmax);
  const int m1 = min(m0 + 1, mmax);
  const int hm0 = max(h >> m0, 1), wm0 = max(w >> m0, 1);
  const int hm1 = max(h >> m1, 1), wm1 = max(w >> m1, 1);

  // level m0's block-row offset (_mip_arith_bc1), its row (int32 wraps
  // as the twin's; _pool_rows clamps below at 0)
  unsigned off = (unsigned)off0[i];
  for (int k = 0; k + 1 < num_mips; ++k) {
    if (m0 > k) {
      off += (unsigned)(((max(h >> k, 1) + 3) >> 2) *
                        ((max(w >> k, 1) + 3) >> 2));
    }
  }
  const Tap c = footprint(wm0, hm0, u, v);
  const int bx = c.x0 >> 2, by = c.y0 >> 2;
  const int idx = (int)(off + (unsigned)(by * ((wm0 + 3) >> 2)) +
                        (unsigned)bx);
  const long long r = idx < 0 ? 0 : idx;
  const uint4* row = pool + 8 * (r < npool ? r : npool - 1);
  const uint2* hrow = aux + 8 * (r < naux ? r : naux - 1);
  const int rx = clamp01((c.x1 >> 2) - bx);
  const int ry = clamp01((c.y1 >> 2) - by);

  // level m1's footprint in the row's parent group
  const bool deep = m1 > m0;
  const Tap p = footprint(wm1, hm1, u, v);
  const int ax = min(max((2 * bx - 1) >> 2, 0), max(((wm1 + 3) >> 2) - 1, 0));
  const int ay = min(max((2 * by - 1) >> 2, 0), max(((hm1 + 3) >> 2) - 1, 0));
  const int sx0 = clamp01((p.x0 >> 2) - ax), sx1 = clamp01((p.x1 >> 2) - ax);
  const int sy0 = clamp01((p.y0 >> 2) - ay), sy1 = clamp01((p.y1 >> 2) - ay);

  // the contraction's weights (_contract_quad), corner-major
  const float cw[4] = {(1.0f - c.fx) * (1.0f - c.fy), c.fx * (1.0f - c.fy),
                       (1.0f - c.fx) * c.fy, c.fx * c.fy};
  const float pw[4] = {(1.0f - p.fx) * (1.0f - p.fy), p.fx * (1.0f - p.fy),
                       (1.0f - p.fx) * p.fy, p.fx * p.fy};

  // eight texels, corner order texel, right, down, down-right at each
  // level; each level's sum in the twin's order
  float s0[4], s1[4];
#pragma unroll 1
  for (int k = 0; k < (deep ? 8 : 4); ++k) {
    const bool up = k >= 4;
    const int q = k & 3;
    const bool right = q & 1, down = q & 2;
    const int xt = up ? (right ? p.x1 : p.x0) : (right ? c.x1 : c.x0);
    const int yt = up ? (down ? p.y1 : p.y0) : (down ? c.y1 : c.y0);
    const int sx = up ? (right ? sx1 : sx0) : (right ? rx : 0);
    const int sy = up ? (down ? sy1 : sy0) : (down ? ry : 0);
    const float wk = q == 0 ? (up ? pw[0] : cw[0])
                   : q == 1 ? (up ? pw[1] : cw[1])
                   : q == 2 ? (up ? pw[2] : cw[2])
                            : (up ? pw[3] : cw[3]);
    int tx[4];
    texel(row, hrow, (up ? 4 : 0) + sx + 2 * sy, (yt & 3) * 4 + (xt & 3),
          modes, tx);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const float part = wk * (float)tx[ch];
      if (up) {
        s1[ch] = q == 0 ? part : s1[ch] + part;
      } else {
        s0[ch] = q == 0 ? part : s0[ch] + part;
      }
    }
  }
  const float g = 1.0f - fm;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    const float b = deep ? s1[ch] : s0[ch];
    out[ch * n + i] = s0[ch] * g + b * fm;
  }
}

}  // namespace

// pool (npool, 128) u8 bc7 rows and aux (naux 64 B hint rows) u8, both
// 16-byte aligned (aux is read only for a listed partitioned mode);
// off0, th, tw (n,) i32 and lod, u, v (n,) f32; out (4, n) f32; modes
// the listed BC7 modes as a bit mask; num_mips in [1, 31]. Launches on
// ``stream`` and returns the launch status; does not synchronise.
extern "C" cudaError_t mtr_bc7_trilinear(
    const void* pool, long long npool, const void* aux, long long naux,
    unsigned modes, const int* off0, const int* th, const int* tw,
    const float* lod, const float* u, const float* v, float* out,
    long long n, int num_mips, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  bc7_trilinear_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint4*)pool, npool, (const uint2*)aux, naux, modes, off0, th,
      tw, lod, u, v, out, n, num_mips);
  return cudaGetLastError();
}
