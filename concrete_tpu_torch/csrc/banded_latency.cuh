// Kernel 9's latency-form product as device functions: the band build from
// int32 digits (or an int8 band), the staging of the lhs rows, and the
// fragment build and mma.sync m16n8k32 chain of one K slice.  Two kernels
// include it with the same arithmetic: banded_mm_latency.cu (one product
// per launch, K split across a cluster) and blind_rotate_latency.cu (every
// step of the latency blind rotate in one launch, t split across a
// cluster).  The product, its layouts and why it is built this way are in
// banded_mm_latency.cu's header comment.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "banded_wgmma.cuh"     // smem_addr, cp_async16

namespace {

using banded::cp_async16;
using banded::smem_addr;

constexpr int LT = 64;            // output coefficients per t-tile: 4 x 16
constexpr int KH = 2;             // K halves: warps 0-3 and 4-7
constexpr int THREADS = 128 * KH; // 8 warps
constexpr int JS_MAX = 1024;      // j per K slice

struct LatShape {
  // lhs[a, r, ci, j] at lhs + a*st_a + r*st_r + (ci / kp1)*st_lev
  //                   + (ci % kp1)*st_rin + j; nothing at or past lhs_end
  // is read
  const int8_t* lhs;
  const int8_t* lhs_end;
  long long st_a, st_r, st_lev, st_rin;
  const int32_t* digits;      // (Cin, B, N), or null: the band is vv
  const int8_t* vv;           // (Cin, B, S, 2N-1)
  int* out;                   // (rows, B, A+S-1, N)
  int a_limbs, rows, cin, kp1, batch, s_planes, n;
  int js, jblocks, slices, cl, per_round, ncols, ntiles;
  int band_words;             // u32 words of one staged band view
  int band_bytes;             // the 4 S band views of a slice, 16-aligned
  int lhs_row;                // bytes of one staged lhs row: js + 16
  int slice_bytes;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Band row x of slice (ci, jb) holds E(u_lo + x), u_lo = t0 - jb*js - js:
// output t meets input j at x = (t - t0) - (j - jb*js) + js.  Word w of
// its view k holds row bytes 4w+k .. 4w+k+3 reversed (byte i is row[4w +
// k + 3 - i], the band at j+i for one output t), built from the row's
// words w and w+1, which pack x = 4w .. 4w+7; views (s, k) lie at
// band + (4s + k) * band_words.  The digits may lie in global or shared
// memory (SHARED: shared, loaded as such).  band_word builds word w of
// every view of one slice.
template <bool DIGITS, bool SHARED = false>
__device__ __forceinline__ void band_word(const LatShape& sh, uint32_t* band,
                                          int ci, int b, int u_lo, int w) {
  const int u0 = u_lo + 4 * w;           // in [-N, N], a multiple of 4
#ifdef ABLATE_NO_BAND_STAGING
  for (int v = 0; v < 4 * sh.s_planes; ++v) band[v * sh.band_words + w] = w;
  return;                                // (leaves work out: times the rest)
#endif
  int x[8];                              // E(u0 .. u0+7)
  const int8_t* vrow = nullptr;
  if (DIGITS) {
    const int32_t* drow = sh.digits + ((size_t)ci * sh.batch + b) * sh.n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + 4 * h;
      const int idx = u < 0 ? u + sh.n : (u >= sh.n ? u - sh.n : u);
      int4 v;
      if (SHARED)
        asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(smem_addr(drow + idx)));
      else
        v = *reinterpret_cast<const int4*>(drow + idx);
      const int sgn = u < 0 ? -1 : 1;
      x[4 * h] = sgn * v.x; x[4 * h + 1] = sgn * v.y;
      x[4 * h + 2] = sgn * v.z; x[4 * h + 3] = sgn * v.w;
    }
  }
  for (int s = 0; s < sh.s_planes; ++s) {
    uint32_t lo = 0, hi = 0;
    if (DIGITS) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t byte = (uint32_t)x[i] & 0xFF;
        if (i < 4) lo |= byte << (8 * i); else hi |= byte << (8 * i - 32);
        x[i] = (x[i] - (int)(int8_t)byte) >> 8;   // the balanced carry
      }
    } else {
      const long long vlen = 2LL * sh.n - 1;
      vrow = sh.vv + (((size_t)ci * sh.batch + b) * sh.s_planes + s) * vlen;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long y = sh.n - 1 + u0 + i;
        const uint32_t byte =
            y >= 0 && y < vlen ? (uint32_t)(uint8_t)vrow[y] : 0;
        if (i < 4) lo |= byte << (8 * i); else hi |= byte << (8 * i - 32);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      band[(4 * s + k) * sh.band_words + w] =
          __byte_perm(__funnelshift_r(lo, hi, 8 * k), 0, 0x0123);
  }
}

// Every word of one slice's band views, the block's threads sharing them.
template <bool DIGITS>
__device__ __forceinline__ void stage_band(const LatShape& sh, uint32_t* band,
                                           int ci, int jb, int t0, int b) {
  const int u_lo = t0 - jb * sh.js - sh.js;
  for (int w = threadIdx.x; w < sh.band_words; w += THREADS)
    band_word<DIGITS>(sh, band, ci, b, u_lo, w);
}

__device__ __forceinline__ const int8_t* lhs_row(const LatShape& sh, int c,
                                                 int ci, int jb) {
  const int r = c / sh.a_limbs, a = c - r * sh.a_limbs;
  const int lev = ci / sh.kp1, rin = ci - lev * sh.kp1;
  return sh.lhs + a * sh.st_a + r * sh.st_r + lev * sh.st_lev +
         rin * sh.st_rin + (long long)jb * sh.js;
}

// The slice's ncols lhs rows, each from the 16-byte boundary at or below
// its start (inside the key's storage), in 16-byte cp.async pieces.
__device__ __forceinline__ void stage_lhs(const LatShape& sh,
                                          unsigned char* rows, int ci,
                                          int jb) {
  const int pieces = sh.lhs_row / 16;
  for (int i = threadIdx.x; i < sh.ncols * pieces; i += THREADS) {
    const int c = i / pieces, pc = i - c * pieces;
    const int8_t* base = (const int8_t*)(
        (uintptr_t)lhs_row(sh, c, ci, jb) & ~(uintptr_t)15);
    const int8_t* src = base + 16 * pc;
    const long long left = (long long)(sh.lhs_end - src);
    const int nb = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
    cp_async16(smem_addr(rows + c * sh.lhs_row + 16 * pc), nb ? src : sh.lhs,
               nb);
  }
}

// The A fragment at word q of a band view (the view y0 mod 4, y0 the
// thread's band row at k-step 0, q = y0 / 4 - 8 ks): a0 holds band row x =
// y+3 .. y (y = y0 - 32 ks) for row g, a1 row g+8 (y + 8), a2 bytes 16.. of
// row g (y - 16), a3 row g+8 (y - 8): words q, q+2, q-4, q-2.
__device__ __forceinline__ void load_a(uint32_t (&af)[4], const uint32_t* band,
                                       int q) {
#ifdef ABLATE_NO_FRAGMENTS
  af[0] = q; af[1] = q + 1; af[2] = threadIdx.x; af[3] = q ^ threadIdx.x;
#else
  af[0] = band[q];
  af[1] = band[q + 2];
  af[2] = band[q - 4];
  af[3] = band[q - 2];
#endif
}

// The B fragment of one column at k-step ks: bytes o.. of its staged row
// (words lrow), o = m + j (m: the row's offset past its 16-byte boundary),
// o0 = m + 4 tg, bsh = 8 (o0 mod 4).
__device__ __forceinline__ void load_b(uint32_t& b0f, uint32_t& b1f,
                                       const uint32_t* lrow, int o0, int bsh,
                                       int ks) {
  const int ob = (o0 >> 2) + 8 * ks;
#ifdef ABLATE_NO_FRAGMENTS
  b0f = ob; b1f = bsh;
#else
  b0f = __funnelshift_r(lrow[ob], lrow[ob + 1], bsh);
  b1f = __funnelshift_r(lrow[ob + 4], lrow[ob + 5], bsh);
#endif
}

// k-steps [ks0, ks0 + half) of slice (ci, jb) into acc, for the warp's 16
// outputs t and the n tile of column c: `band` points at the view y0 mod
// 4, the column's staged row is `rows` + c * lhs_row.
__device__ __forceinline__ void mma_chain(int (&acc)[4], const uint32_t* band,
                                          const unsigned char* rows,
                                          const LatShape& sh, int c, int ci,
                                          int jb, int y0, int tg, int ks0,
                                          int half) {
  const bool live = c < sh.ncols;
  const int m = live ? (int)((uintptr_t)lhs_row(sh, c, ci, jb) & 15) : 0;
  const uint32_t* lrow =
      reinterpret_cast<const uint32_t*>(rows + (live ? c : 0) * sh.lhs_row);
  const int o0 = m + 4 * tg, bsh = 8 * (o0 & 3);
#pragma unroll 4
  for (int ks = ks0; ks < ks0 + half; ++ks) {
    uint32_t af[4], b0f, b1f;
    load_a(af, band, (y0 >> 2) - 8 * ks);
    load_b(b0f, b1f, lrow, o0, bsh, ks);
    if (!live) b0f = b1f = 0;
    mma_s8(acc, af, b0f, b1f);
  }
}

}  // namespace
