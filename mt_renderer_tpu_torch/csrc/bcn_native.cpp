// bcn_native — the port's host BC1 and BC7 block codecs.
//
// The entry points that mt_renderer_tpu_torch/native.py binds:
//
//   * mtr_decode_bc1 / mtr_encode_bc1: BC1 block decode, and the
//     bounding-box encoder of the bc1 pool's content pipeline,
//   * mtr_decode_bc7: BC7 block decode, all 8 modes, per the format's
//     specification (the partition, anchor and weight tables below are
//     its constants, the same values as render/bcn.py).
//
// Byte-exact with render/bcn.py's NumPy decoders and encoder. Plain C
// ABI, consumed from Python via ctypes; native.py builds it with g++ at
// first use. All functions return 0 on success, negative on error.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------- BC1

// Decode BC1 blocks into (height, width, 4) RGBA8 (row-major). Matches
// render/bcn.py decode_bc1_numpy byte-for-byte.
extern "C" int mtr_decode_bc1(const uint8_t* blocks, int width, int height,
                   uint8_t* out) {
  const int bw = (width + 3) / 4, bh = (height + 3) / 4;
  for (int by = 0; by < bh; by++) {
    for (int bx = 0; bx < bw; bx++) {
      const uint8_t* blk = blocks + (by * bw + bx) * 8;
      uint32_t c0 = blk[0] | (blk[1] << 8);
      uint32_t c1 = blk[2] | (blk[3] << 8);
      uint32_t bits = blk[4] | (blk[5] << 8) | (blk[6] << 16) |
                      (static_cast<uint32_t>(blk[7]) << 24);

      auto expand = [](uint32_t c, uint32_t* r, uint32_t* g, uint32_t* b) {
        uint32_t r5 = (c >> 11) & 0x1F, g6 = (c >> 5) & 0x3F, b5 = c & 0x1F;
        *r = (r5 << 3) | (r5 >> 2);
        *g = (g6 << 2) | (g6 >> 4);
        *b = (b5 << 3) | (b5 >> 2);
      };
      uint32_t r0, g0, b0, r1, g1, b1;
      expand(c0, &r0, &g0, &b0);
      expand(c1, &r1, &g1, &b1);

      uint8_t pal[4][4];
      auto set = [&pal](int i, uint32_t r, uint32_t g, uint32_t b,
                        uint32_t a) {
        pal[i][0] = static_cast<uint8_t>(r);
        pal[i][1] = static_cast<uint8_t>(g);
        pal[i][2] = static_cast<uint8_t>(b);
        pal[i][3] = static_cast<uint8_t>(a);
      };
      set(0, r0, g0, b0, 255);
      set(1, r1, g1, b1, 255);
      if (c0 > c1) {
        set(2, (2 * r0 + r1 + 1) / 3, (2 * g0 + g1 + 1) / 3,
            (2 * b0 + b1 + 1) / 3, 255);
        set(3, (r0 + 2 * r1 + 1) / 3, (g0 + 2 * g1 + 1) / 3,
            (b0 + 2 * b1 + 1) / 3, 255);
      } else {
        set(2, (r0 + r1) / 2, (g0 + g1) / 2, (b0 + b1) / 2, 255);
        set(3, 0, 0, 0, 0);
      }

      for (int t = 0; t < 16; t++) {
        int px = bx * 4 + (t % 4), py = by * 4 + (t / 4);
        if (px >= width || py >= height) continue;
        const uint8_t* c = pal[(bits >> (2 * t)) & 0x3];
        std::memcpy(out + (py * width + px) * 4, c, 4);
      }
    }
  }
  return 0;
}

// Encode (height, width, 4) RGBA8 -> BC1 blocks (8 B each, raster
// block order). Bit-exact port of render/bcn.py::encode_bc1_numpy
// (bounding-box fit, nearest decoded palette entry, alpha<128 ->
// 3-color punch-through) — the content pipeline for the compressed-
// resident texel pool; the NumPy path measured ~150 s for the bigtex
// texture set, this threads it down to seconds. nthreads<=0 -> auto.
extern "C" int mtr_encode_bc1(const uint8_t* src, int width, int height,
                              uint8_t* out, int nthreads) {
  const int bw = (width + 3) / 4, bh = (height + 3) / 4;
  const int n = bw * bh;
  if (nthreads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    nthreads = hc ? static_cast<int>(hc) : 1;
  }
  if (nthreads > n) nthreads = n > 0 ? n : 1;

  auto q565 = [](const int* c) -> uint32_t {
    uint32_t r = (c[0] * 31 + 127) / 255;
    uint32_t g = (c[1] * 63 + 127) / 255;
    uint32_t b = (c[2] * 31 + 127) / 255;
    return (r << 11) | (g << 5) | b;
  };
  auto expand = [](uint32_t c, int* rgb) {
    uint32_t r5 = (c >> 11) & 0x1F, g6 = (c >> 5) & 0x3F, b5 = c & 0x1F;
    rgb[0] = static_cast<int>((r5 << 3) | (r5 >> 2));
    rgb[1] = static_cast<int>((g6 << 2) | (g6 >> 4));
    rgb[2] = static_cast<int>((b5 << 3) | (b5 >> 2));
  };

  auto work = [&](int lo_b, int hi_b) {
    for (int b = lo_b; b < hi_b; b++) {
      const int bx = b % bw, by = b / bw;
      int rgb[16][3];
      bool transp[16];
      bool has_t = false, any_opq = false;
      for (int t = 0; t < 16; t++) {
        int px = bx * 4 + (t % 4), py = by * 4 + (t / 4);
        if (px > width - 1) px = width - 1;    // edge-replicate pad
        if (py > height - 1) py = height - 1;
        const uint8_t* p = src + (py * width + px) * 4;
        rgb[t][0] = p[0]; rgb[t][1] = p[1]; rgb[t][2] = p[2];
        transp[t] = p[3] < 128;
        has_t |= transp[t];
        any_opq |= !transp[t];
      }
      int lo[3] = {0, 0, 0}, hi[3] = {0, 0, 0};
      if (any_opq) {
        for (int c = 0; c < 3; c++) { lo[c] = 255; hi[c] = 0; }
        for (int t = 0; t < 16; t++) {
          if (transp[t]) continue;
          for (int c = 0; c < 3; c++) {
            if (rgb[t][c] < lo[c]) lo[c] = rgb[t][c];
            if (rgb[t][c] > hi[c]) hi[c] = rgb[t][c];
          }
        }
      }
      uint32_t chi = q565(hi), clo = q565(lo);
      uint32_t c0 = has_t ? (chi < clo ? chi : clo)
                          : (chi > clo ? chi : clo);
      uint32_t c1 = has_t ? (chi > clo ? chi : clo)
                          : (chi < clo ? chi : clo);
      const bool four = c0 > c1;
      int e0[3], e1[3], pal[4][3];
      expand(c0, e0);
      expand(c1, e1);
      for (int c = 0; c < 3; c++) {
        pal[0][c] = e0[c];
        pal[1][c] = e1[c];
        pal[2][c] = four ? (2 * e0[c] + e1[c] + 1) / 3
                         : (e0[c] + e1[c]) / 2;
        pal[3][c] = four ? (e0[c] + 2 * e1[c] + 1) / 3 : 0;
      }
      const bool mask3 = !four && has_t;  // slot 3 = transparent
      uint32_t bits = 0;
      for (int t = 0; t < 16; t++) {
        uint32_t idx;
        if (transp[t] && has_t) {
          idx = 3;
        } else {
          int best = 0x7fffffff;
          idx = 0;
          const int ne = mask3 ? 3 : 4;
          for (int e = 0; e < ne; e++) {
            int d = 0;
            for (int c = 0; c < 3; c++) {
              int df = rgb[t][c] - pal[e][c];
              d += df * df;
            }
            if (d < best) { best = d; idx = static_cast<uint32_t>(e); }
          }
        }
        bits |= idx << (2 * t);
      }
      uint8_t* o = out + b * 8;
      o[0] = static_cast<uint8_t>(c0 & 0xFF);
      o[1] = static_cast<uint8_t>(c0 >> 8);
      o[2] = static_cast<uint8_t>(c1 & 0xFF);
      o[3] = static_cast<uint8_t>(c1 >> 8);
      o[4] = static_cast<uint8_t>(bits & 0xFF);
      o[5] = static_cast<uint8_t>((bits >> 8) & 0xFF);
      o[6] = static_cast<uint8_t>((bits >> 16) & 0xFF);
      o[7] = static_cast<uint8_t>(bits >> 24);
    }
  };

  if (nthreads == 1) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  int chunk = (n + nthreads - 1) / nthreads;
  for (int i = 0; i < nthreads; i++) {
    int lo_b = i * chunk, hi_b = lo_b + chunk < n ? lo_b + chunk : n;
    if (lo_b >= hi_b) break;
    threads.emplace_back(work, lo_b, hi_b);
  }
  for (auto& t : threads) t.join();
  return 0;
}

// ---------------------------------------------------------------- BC7
//
// All 8 modes per the BC7 spec; partition/anchor/weight tables are the
// public spec constants (same values as render/bcn.py).

static const uint8_t kP2[64][16] = {
    {0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1},{0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1},
    {0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1},{0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1},
    {0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1},
    {0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1},
    {0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1},
    {0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1},
    {0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1},
    {0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1},{0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1},
    {0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1},{0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0},
    {0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0},{0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0},
    {0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0},{0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0},
    {0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0},{0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1},
    {0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0},{0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0},
    {0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0},{0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0},
    {0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0},{0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0},
    {0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0},{0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0},
    {0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1},{0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1},
    {0,1,0,1,1,0,1,0,0,1,0,1,1,0,1,0},{0,0,1,1,0,0,1,1,1,1,0,0,1,1,0,0},
    {0,0,1,1,1,1,0,0,0,0,1,1,1,1,0,0},{0,1,0,1,0,1,0,1,1,0,1,0,1,0,1,0},
    {0,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1},{0,1,0,1,1,0,1,0,1,0,1,0,0,1,0,1},
    {0,1,1,1,0,0,1,1,1,1,0,0,1,1,1,0},{0,0,0,1,0,0,1,1,1,1,0,0,1,0,0,0},
    {0,0,1,1,0,0,1,0,0,1,0,0,1,1,0,0},{0,0,1,1,1,0,1,1,1,1,0,1,1,1,0,0},
    {0,1,1,0,1,0,0,1,1,0,0,1,0,1,1,0},{0,0,1,1,1,1,0,0,1,1,0,0,0,0,1,1},
    {0,1,1,0,0,1,1,0,1,0,0,1,1,0,0,1},{0,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0},
    {0,1,0,0,1,1,1,0,0,1,0,0,0,0,0,0},{0,0,1,0,0,1,1,1,0,0,1,0,0,0,0,0},
    {0,0,0,0,0,0,1,0,0,1,1,1,0,0,1,0},{0,0,0,0,0,1,0,0,1,1,1,0,0,1,0,0},
    {0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1},{0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,1},
    {0,1,1,0,0,0,1,1,1,0,0,1,1,1,0,0},{0,0,1,1,1,0,0,1,1,1,0,0,0,1,1,0},
    {0,1,1,0,1,1,0,0,1,1,0,0,1,0,0,1},{0,1,1,0,0,0,1,1,0,0,1,1,1,0,0,1},
    {0,1,1,1,1,1,1,0,1,0,0,0,0,0,0,1},{0,0,0,1,1,0,0,0,1,1,1,0,0,1,1,1},
    {0,0,0,0,1,1,1,1,0,0,1,1,0,0,1,1},{0,0,1,1,0,0,1,1,1,1,1,1,0,0,0,0},
    {0,0,1,0,0,0,1,0,1,1,1,0,1,1,1,0},{0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1},
};

static const uint8_t kP3[64][16] = {
    {0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2},{0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1},
    {0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1},{0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1},
    {0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2},{0,0,1,1,0,0,1,1,0,0,2,2,0,0,2,2},
    {0,0,2,2,0,0,2,2,1,1,1,1,1,1,1,1},{0,0,1,1,0,0,1,1,2,2,1,1,2,2,1,1},
    {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2},{0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2},
    {0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2},{0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2},
    {0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2},{0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2},
    {0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2},{0,0,1,1,2,0,0,1,2,2,0,0,2,2,2,0},
    {0,0,0,1,0,0,1,1,0,1,1,2,1,1,2,2},{0,1,1,1,0,0,1,1,2,0,0,1,2,2,0,0},
    {0,0,0,0,1,1,2,2,1,1,2,2,1,1,2,2},{0,0,2,2,0,0,2,2,0,0,2,2,1,1,1,1},
    {0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2},{0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1},
    {0,0,0,0,0,0,1,1,0,1,2,2,0,1,2,2},{0,0,0,0,1,1,0,0,2,2,1,0,2,2,1,0},
    {0,1,2,2,0,1,2,2,0,0,1,1,0,0,0,0},{0,0,1,2,0,0,1,2,1,1,2,2,2,2,2,2},
    {0,1,1,0,1,2,2,1,1,2,2,1,0,1,1,0},{0,0,0,0,0,1,1,0,1,2,2,1,1,2,2,1},
    {0,0,2,2,1,1,0,2,1,1,0,2,0,0,2,2},{0,1,1,0,0,1,1,0,2,0,0,2,2,2,2,2},
    {0,0,1,1,0,1,2,2,0,1,2,2,0,0,1,1},{0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1},
    {0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2},{0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1},
    {0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2},{0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0},
    {0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0},{0,1,2,0,1,2,0,1,2,0,1,2,0,1,2,0},
    {0,1,2,0,2,0,1,2,1,2,0,1,0,1,2,0},{0,0,1,1,2,2,0,0,1,1,2,2,0,0,1,1},
    {0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1},{0,1,0,1,0,1,0,1,2,2,2,2,2,2,2,2},
    {0,0,0,0,0,0,0,0,2,1,2,1,2,1,2,1},{0,0,2,2,1,1,2,2,0,0,2,2,1,1,2,2},
    {0,0,2,2,0,0,1,1,0,0,2,2,0,0,1,1},{0,2,2,0,1,2,2,1,0,2,2,0,1,2,2,1},
    {0,1,0,1,2,2,2,2,2,2,2,2,0,1,0,1},{0,0,0,0,2,1,2,1,2,1,2,1,2,1,2,1},
    {0,1,0,1,0,1,0,1,0,1,0,1,2,2,2,2},{0,2,2,2,0,1,1,1,0,2,2,2,0,1,1,1},
    {0,0,0,2,1,1,1,2,0,0,0,2,1,1,1,2},{0,0,0,0,2,1,1,2,2,1,1,2,2,1,1,2},
    {0,2,2,2,0,1,1,1,0,1,1,1,0,2,2,2},{0,0,0,2,1,1,1,2,1,1,1,2,0,0,0,2},
    {0,1,1,0,0,1,1,0,0,1,1,0,2,2,2,2},{0,0,0,0,0,0,0,0,2,1,1,2,2,1,1,2},
    {0,1,1,0,0,1,1,0,2,2,2,2,2,2,2,2},{0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2},
    {0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2},{0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2},
    {0,0,0,2,0,0,0,1,0,0,0,2,0,0,0,1},{0,2,2,2,1,2,2,2,0,2,2,2,1,2,2,2},
    {0,1,0,1,2,2,2,2,2,2,2,2,2,2,2,2},{0,1,1,1,2,0,1,1,2,2,0,1,2,2,2,0},
};

static const uint8_t kAnchor2_1[64] = {
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15, 2, 8, 2, 2, 8, 8,15, 2, 8, 2, 2, 8, 8, 2, 2,
    15,15, 6, 8, 2, 8,15,15, 2, 8, 2, 2, 2,15,15, 6,
     6, 2, 6, 8,15,15, 2, 2,15,15,15,15,15, 2, 2,15,
};
static const uint8_t kAnchor3_1[64] = {
     3, 3,15,15, 8, 3,15,15, 8, 8, 6, 6, 6, 5, 3, 3,
     3, 3, 8,15, 3, 3, 6,10, 5, 8, 8, 6, 8, 5,15,15,
     8,15, 3, 5, 6,10, 8,15,15, 3,15, 5,15,15,15,15,
     3,15, 5, 5, 5, 8, 5,10, 5,10, 8,13,15,12, 3, 3,
};
static const uint8_t kAnchor3_2[64] = {
    15, 8, 8, 3,15,15, 3, 8,15,15,15,15,15,15,15, 8,
    15, 8,15, 3,15, 8,15, 8, 3,15, 6,10,15,15,10, 8,
    15, 3,15,10,10, 8, 9,10, 6,15, 8,15, 3, 6, 6, 8,
    15, 3,15,15,15,15,15,15,15,15,15,15, 3,15,15, 8,
};

static const uint16_t kW2[4] = {0, 21, 43, 64};
static const uint16_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
static const uint16_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30,
                                 34, 38, 43, 47, 51, 55, 60, 64};

struct Bc7Mode {
  uint8_t nsub, pbits, rot, isb, cb, ab, npb, shared_pb, ib, ib2;
};
static const Bc7Mode kModes[8] = {
    {3, 4, 0, 0, 4, 0, 6, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 2, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 4, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 2, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 4, 0, 2, 0},
};

struct BitReader128 {
  uint64_t lo, hi;
  int pos;
  uint32_t get(int count) {
    if (count == 0) return 0;
    uint64_t mask = (count >= 64) ? ~0ull : ((1ull << count) - 1);
    uint64_t v;
    if (pos + count <= 64) {
      v = lo >> pos;
    } else if (pos >= 64) {
      v = hi >> (pos - 64);
    } else {
      v = (lo >> pos) | (hi << (64 - pos));
    }
    pos += count;
    return static_cast<uint32_t>(v & mask);
  }
};

static inline uint32_t unquant(uint32_t ep, int bits, int pbit) {
  if (pbit >= 0) {
    ep = (ep << 1) | static_cast<uint32_t>(pbit);
    bits += 1;
  }
  ep <<= (8 - bits);
  return ep | (ep >> bits);
}

// Decode one 16-byte BC7 block into texels[16][4].
static void decode_bc7_block(const uint8_t* blk, uint8_t texels[16][4]) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < 8; i++) lo |= static_cast<uint64_t>(blk[i]) << (8 * i);
  for (int i = 0; i < 8; i++)
    hi |= static_cast<uint64_t>(blk[8 + i]) << (8 * i);

  int mode = -1;
  for (int m = 0; m < 8; m++) {
    if ((lo >> m) & 1) { mode = m; break; }
  }
  if (mode < 0) {  // reserved: no mode bit in the first byte -> zeros
    std::memset(texels, 0, 64);
    return;
  }
  const Bc7Mode& md = kModes[mode];
  BitReader128 br{lo, hi, mode + 1};

  uint32_t partition = br.get(md.pbits);
  uint32_t rotation = br.get(md.rot);
  uint32_t idx_mode = br.get(md.isb);

  const int neps = md.nsub * 2;
  const int nchan = md.ab ? 4 : 3;
  uint32_t chans[4][6];  // channel-major endpoint values
  for (int c = 0; c < nchan; c++) {
    int bits_c = (c < 3) ? md.cb : md.ab;
    for (int e = 0; e < neps; e++) chans[c][e] = br.get(bits_c);
  }

  int pvals[6];
  for (int e = 0; e < neps; e++) pvals[e] = -1;
  if (md.npb) {
    uint32_t raw[6];
    for (int i = 0; i < md.npb; i++) raw[i] = br.get(1);
    for (int e = 0; e < neps; e++)
      pvals[e] = static_cast<int>(md.shared_pb ? raw[e / 2] : raw[e]);
  }

  uint32_t eps[6][4];
  for (int e = 0; e < neps; e++) {
    for (int c = 0; c < 4; c++) {
      if (c < nchan) {
        int bits_c = (c < 3) ? md.cb : md.ab;
        eps[e][c] = unquant(chans[c][e], bits_c, pvals[e]);
      } else {
        eps[e][c] = 255;
      }
    }
  }

  const uint8_t* subset;
  static const uint8_t kZeros[16] = {0};
  int anchors[3] = {0, -1, -1};
  int nanchor = 1;
  if (md.nsub == 1) {
    subset = kZeros;
  } else if (md.nsub == 2) {
    subset = kP2[partition];
    anchors[1] = kAnchor2_1[partition];
    nanchor = 2;
  } else {
    subset = kP3[partition];
    anchors[1] = kAnchor3_1[partition];
    anchors[2] = kAnchor3_2[partition];
    nanchor = 3;
  }

  auto read_index_set = [&](int width, const int* anchor_list, int nanch,
                            uint32_t out_idx[16]) {
    for (int t = 0; t < 16; t++) {
      int w = width;
      for (int a = 0; a < nanch; a++)
        if (anchor_list[a] == t) { w = width - 1; break; }
      out_idx[t] = br.get(w);
    }
  };

  uint32_t idx1[16], idx2[16];
  read_index_set(md.ib, anchors, nanchor, idx1);
  if (md.ib2) {
    static const int anchor0[1] = {0};
    read_index_set(md.ib2, anchor0, 1, idx2);
  }

  for (int t = 0; t < 16; t++) {
    int s = subset[t];
    const uint32_t* e0 = eps[s * 2];
    const uint32_t* e1 = eps[s * 2 + 1];
    uint32_t wc, wa;
    if (mode == 4) {
      wc = (idx_mode == 0) ? kW2[idx1[t]] : kW3[idx2[t]];
      wa = (idx_mode == 0) ? kW3[idx2[t]] : kW2[idx1[t]];
    } else if (mode == 5) {
      wc = kW2[idx1[t]];
      wa = kW2[idx2[t]];
    } else {
      wc = (md.ib == 2) ? kW2[idx1[t]]
                        : (md.ib == 3 ? kW3[idx1[t]] : kW4[idx1[t]]);
      wa = wc;
    }
    for (int c = 0; c < 4; c++) {
      uint32_t w = (c < 3) ? wc : wa;
      texels[t][c] =
          static_cast<uint8_t>((e0[c] * (64 - w) + e1[c] * w + 32) >> 6);
    }
    if (rotation) {
      int c = static_cast<int>(rotation) - 1;  // swap channel c with alpha
      uint8_t tmp = texels[t][c];
      texels[t][c] = texels[t][3];
      texels[t][3] = tmp;
    }
  }
}

// Decode BC7 blocks into (height, width, 4) RGBA8. nthreads<=0 -> auto.
extern "C" int mtr_decode_bc7(const uint8_t* blocks, int width, int height,
                              uint8_t* out, int nthreads) {
  const int bw = (width + 3) / 4, bh = (height + 3) / 4;
  const int n = bw * bh;
  if (nthreads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    nthreads = hc ? static_cast<int>(hc) : 1;
  }
  if (nthreads > n) nthreads = n > 0 ? n : 1;

  auto work = [&](int lo_b, int hi_b) {
    for (int b = lo_b; b < hi_b; b++) {
      uint8_t texels[16][4];
      decode_bc7_block(blocks + b * 16, texels);
      const int bx = b % bw, by = b / bw;
      for (int t = 0; t < 16; t++) {
        int px = bx * 4 + (t % 4), py = by * 4 + (t / 4);
        if (px >= width || py >= height) continue;
        std::memcpy(out + (py * width + px) * 4, texels[t], 4);
      }
    }
  };

  if (nthreads == 1) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  int chunk = (n + nthreads - 1) / nthreads;
  for (int i = 0; i < nthreads; i++) {
    int lo_b = i * chunk, hi_b = lo_b + chunk < n ? lo_b + chunk : n;
    if (lo_b >= hi_b) break;
    threads.emplace_back(work, lo_b, hi_b);
  }
  for (auto& t : threads) t.join();
  return 0;
}
