// Kernel 2 of the CRT-NTT path: the forward negacyclic NTT of signed 64-bit
// polynomials modulo every CRT prime, as one kernel template with two
// epilogues: the standalone transform (ntt_forward: (M, N) -> (P, M, N)
// residues, bit-reversed order) and the bootstrap-key pack
// (ntt_forward_pack: the u64 key's polynomials shifted right by the
// truncation in the kernel, the spectra and their Shoup companions stored
// straight into the FusedBSK layout (n_small, P * rows, N), row
// (pr * Cin + ci) * (k+1) + co of each step).  The inverse is
// csrc/ntt_inverse.cu.
//
// Replaces the TPU kernel concrete_tpu/ops/pallas_ntt.py ntt_fwd_pallas
// (:374, its two pallas_calls :383 and :403).  That runs a four-step
// transform as int8 MXU matmuls with Montgomery combines, because the TPU's
// vector unit has no 32x32->64 multiply; Hopper has one (IMAD.HI), so this
// is a radix-2 transform with Shoup multiplies (csrc/ntt.cuh), in the
// output order of a bit-reversed transform instead of the four-step one
// (tests map one to the other).
//
// Bound: operations at the pack shape (6576 polynomials of N = 4096, 3
// primes): (N/2) log2 N butterflies per polynomial and prime against 8
// bytes in and 4 P out per coefficient (8 P with the pack's companions,
// which make the pack's bound bytes).  Design:
//  - one block per polynomial computes all P primes, so the int64 input is
//    read from HBM once; below N = 16384 each thread keeps its 16 inputs
//    in registers across the primes, at N = 16384 (two groups a thread)
//    it reads them again, from L2, for each prime, one group's after the
//    other's first pass;
//  - a thread is held to 80 registers at N = 1024 .. 4096, three blocks of
//    256 threads a SM at N = 4096 (min_blocks_of in csrc/ntt_regs.cuh);
//  - the loads are coalesced 8-byte loads: the first pass's groups are
//    strided by N/16, so a warp reads 256 consecutive bytes per load;
//  - the reduction to residues takes no division: v = hi 2^32 + lo - s 2^64
//    (s the sign bit) is hi (2^32 mod p) + lo by two Shoup products, less
//    2^64 mod p when v < 0, with per-prime constants from ops/ntt.py
//    constants;
//  - the transform runs in registers through csrc/ntt_regs.cuh, kernel 3's
//    schedule: 16 residues a thread, up to 4 stages a pass, one barrier
//    per exchange, 3 passes at N = 4096, paired twiddles; the last pass
//    reads a thread's consecutive twiddle pairs by 16-byte loads
//    (last_pass);
//  - the last pass leaves residues 16g..16g+15 in thread g; a warp's 512
//    words go through its own 2 KB of shared memory so that each of its
//    four 16-byte stores writes 512 consecutive bytes (store_spectrum);
//    the pack's companions floor(v 2^32 / p) come from the reciprocal
//    floor(2^64 / p) and one correction (companion), no division.
// Compiled once per N: N >= 16 through the register schedule (one block of
// N/16 threads, or 512 threads of two groups at N = 16384), N = 4 and 8 by
// one thread per transform (ntt_forward_tiny); the pack at the sizes the
// CRT-NTT path packs, N = 1024 .. 16384, and at N = 256 and 512, where the
// WoP vertical packing transforms its runtime GGSWs (core/kernels_wop.py).  The ABLATE_* switches are
// set only by tools/ablate_kernels.py's variant builds.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_regs.cuh"

namespace {

// registers a thread of the forward is held to at N = 1024 .. 4096: three
// blocks of 256 threads a SM at N = 4096, the fastest cap of those
// tools/ablate_kernels.py times (ABLATE_REGS)
#ifdef ABLATE_REGS
constexpr int FORWARD_REGS = ABLATE_REGS;
#else
constexpr int FORWARD_REGS = 80;
#endif

// A prime's constants (ops/ntt.py constants: (P, 8) u32 rows p, N^-1 mod
// p, its companion, 2^32 mod p, its companion, floor(2^64 / p) as its
// high and low words, 2^64 mod p), those the forward transform reads.
struct Reduce {
  uint32_t p, c32, c32_sh, r_hi, r_lo, c64;
};

__device__ __forceinline__ Reduce reduce_of(const uint32_t* __restrict__ c) {
  return Reduce{__ldg(c), __ldg(c + 3), __ldg(c + 4), __ldg(c + 5),
                __ldg(c + 6), __ldg(c + 7)};
}

// The canonical residue of a signed 64-bit v = hi 2^32 + lo - s 2^64:
// Shoup products of hi by 2^32 mod p and of lo by 1 (floor(2^32 / p) is
// its companion, r_hi), each canonical, summed, and 2^64 mod p taken off
// when v < 0.
__device__ __forceinline__ uint32_t residue(long long v, const Reduce& c) {
#ifdef ABLATE_NO_REDUCTION
  return (uint32_t)v;
#else
  const uint32_t lo = (uint32_t)v;
  const uint32_t hi = (uint32_t)((unsigned long long)v >> 32);
  const uint32_t r = ntt::add_mod(ntt::shoup_mul(hi, c.c32, c.c32_sh, c.p),
                                  ntt::shoup_mul(lo, 1u, c.r_hi, c.p), c.p);
  return (int32_t)hi < 0 ? ntt::sub_mod(r, c.c64, c.p) : r;
#endif
}

// The Shoup companion floor(v 2^32 / p) of v < p: with floor(2^64 / p) =
// r_hi 2^32 + r_lo, q = v r_hi + umulhi(v, r_lo) = floor(v floor(2^64 / p)
// / 2^32) falls short of the quotient by at most one (the reciprocal's
// error costs less than v / 2^32 < 1/2), and the remainder v 2^32 - q p,
// in [0, 2p) and so exact mod 2^32, says whether it did.
__device__ __forceinline__ uint32_t companion(uint32_t v, const Reduce& c) {
  const uint32_t q = v * c.r_hi + __umulhi(v, c.r_lo);
  return 0u - q * c.p >= c.p ? q + 1 : q;
}

// Residues 16g .. 16g+15 of each of the thread's groups (where the last
// pass leaves them) into row `val`, and for the pack (PACK) their
// companions into row `sh`.  With whole warps (T >= 32), a warp's 32
// groups are 512 consecutive words, moved through the warp's own 512
// words of shared memory (16-byte slots rotated by row, free of bank
// conflicts) so that each 16-byte store of the warp writes 512
// consecutive bytes; a thread's own four 16-byte stores, at a 64-byte
// stride, would write each 32-byte sector in two halves.  (Blocks of
// fewer than 32 threads, N < 512, store their own.)
template <int G, int T, bool PACK>
__device__ __forceinline__ void store_spectrum(const uint32_t (&x)[G][E],
                                               uint32_t* __restrict__ val,
                                               uint32_t* __restrict__ sh,
                                               const Reduce& c,
                                               uint32_t* region) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * T, g0 = g - lane;
    uint4* w = reinterpret_cast<uint4*>(region + E * g0);
#pragma unroll
    for (int part = 0; part < (PACK ? 2 : 1); ++part) {
      uint32_t* row = part ? sh : val;
      uint4 v[E / 4];
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const uint32_t* r = x[i] + 4 * q;
        v[q] = part ? make_uint4(companion(r[0], c), companion(r[1], c),
                                 companion(r[2], c), companion(r[3], c))
                    : make_uint4(r[0], r[1], r[2], r[3]);
      }
#ifdef ABLATE_NO_STORE
      // a sink the compiler keeps, storing with chance 2^-32
      uint32_t s = 0;
#pragma unroll
      for (int q = 0; q < E / 4; ++q) s ^= v[q].x ^ v[q].y ^ v[q].z ^ v[q].w;
      if (s == 0xFFFFFFFFu) row[g] = s;
#else
#ifdef ABLATE_DIRECT_STORES
      constexpr bool direct = true;
#else
      constexpr bool direct = T < 32;
#endif
      if constexpr (direct) {
#pragma unroll
        for (int q = 0; q < E / 4; ++q)
          reinterpret_cast<uint4*>(row + E * g)[q] = v[q];
      } else {
        __syncwarp();
#pragma unroll
        for (int q = 0; q < E / 4; ++q)
          w[4 * lane + ((q + (lane >> 1)) & 3)] = v[q];
        __syncwarp();
        uint4* dst = reinterpret_cast<uint4*>(row + E * g0);
#pragma unroll
        for (int j = 0; j < E / 4; ++j) {
          const int r = 8 * j + (lane >> 2), q = lane & 3;
          dst[32 * j + lane] = w[4 * r + ((q + (r >> 1)) & 3)];
        }
      }
#endif
    }
  }
}

// The last forward pass (stride 1, group g holding residues 16g .. 16g+15,
// blk = g in pass): stage q of its R reads the 2^(4-R+q) consecutive
// twiddle pairs from 2^(s0+q) + g 2^(4-R+q) by 16-byte loads, where
// pass's 8-byte loads of them had each warp's lanes at strides of up to
// 64 bytes.
template <int R>
__device__ __forceinline__ void last_pass(uint32_t (&x)[E], int g, int s0,
                                          const uint2* __restrict__ tw,
                                          uint32_t p) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int pairs = 1 << (4 - R + q), dk = 1 << (R - 1 - q);
    const uint2* t = tw + (1 << (s0 + q)) + g * pairs;
    uint2 w[8];
    if (pairs == 1) {
      w[0] = __ldg(t);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (2 * v >= pairs) break;
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(t) + v);
        w[2 * v] = make_uint2(u.x, u.y);
        w[2 * v + 1] = make_uint2(u.z, u.w);
      }
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (k & dk) continue;
      const uint2 sw = w[k >> (R - q)];
      ntt::ct_butterfly(x[k], x[k + dk], sw.x, sw.y, p);
    }
  }
}

__device__ __forceinline__ void run_last_pass(int r, uint32_t (&x)[E], int g,
                                              int s0,
                                              const uint2* __restrict__ tw,
                                              uint32_t p) {
  switch (r) {
    case 4: last_pass<4>(x, g, s0, tw, p); break;
    case 3: last_pass<3>(x, g, s0, tw, p); break;
    case 2: last_pass<2>(x, g, s0, tw, p); break;
    default: last_pass<1>(x, g, s0, tw, p); break;
  }
}

// Block m transforms polynomial m (x row m, each value >> shift) mod every
// prime; its spectrum mod prime pr goes to row (s P + pr) rows + r of out
// (and of out_sh: PACK), m = s rows + r.  The standalone transform passes
// rows = M (so row pr M + m) and shift 0.
template <int LOG_N, bool PACK>
__global__ void __launch_bounds__(threads_of(LOG_N),
                                  min_blocks_of(LOG_N, FORWARD_REGS))
ntt_forward_kernel(
    const long long* __restrict__ x, uint32_t* __restrict__ out,
    uint32_t* __restrict__ out_sh, const uint2* __restrict__ tw,
    const uint32_t* __restrict__ consts, int rows, int n_primes,
    int shift) {
  // [2][N] swizzled exchange buffers, then [N] for the stores, each warp's
  // 512 words at 16 (g - lane)
  extern __shared__ uint32_t buf[];
  constexpr int n = 1 << LOG_N, npass = (LOG_N + 3) / 4;
  constexpr int G = LOG_N == 14 ? 2 : 1;       // 1024 groups: 512 threads
  constexpr int T = n / (E * G), ls0 = LOG_N - 4;
  constexpr bool KEEP = G == 1;                // inputs held across primes
  const int m = blockIdx.x, tid = threadIdx.x;
  const long long* src = x + (size_t)m * n;
  long long in[KEEP ? E : 1];
  if constexpr (KEEP) {
#pragma unroll
    for (int k = 0; k < E; ++k) in[k] = __ldg(src + pos(tid, ls0, k)) >> shift;
  }
  const int s = m / rows, r = m - s * rows;
  int ex = 0;
  for (int pr = 0; pr < n_primes; ++pr) {
    const Reduce c = reduce_of(consts + 8 * pr);
    const uint2* fwd = tw + (size_t)pr * 2 * n;
    uint32_t xr[G][E];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int g = tid + i * T;
      // group i's loads wait for group 0's first pass (xr[0][0] < p < 2^31
      // makes the offset 0, which the compiler cannot know), so a thread
      // never holds both groups' int64 inputs at once: without it the
      // compiler hoists both groups' loads and spills at N = 16384
      const long long* src_i = src + (i ? xr[0][0] >> 31 : 0);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        long long v;
        if constexpr (KEEP)
          v = in[k];
        else
          v = __ldg(src_i + pos(g, ls0, k)) >> shift;
        xr[i][k] = residue(v, c);
      }
      pass<4, false>(xr[i], g, ls0, 0, fwd, c.p);
    }
#pragma unroll
    for (int q = 1; q < npass; ++q) {
      exchange<G>(xr, buf, n, ex, LOG_N, q - 1, q);
#pragma unroll
      for (int i = 0; i < G; ++i) {
#ifndef ABLATE_SCALAR_TWIDDLES
        if (q == npass - 1)
          run_last_pass(pass_stages(LOG_N, q), xr[i], tid + i * T, 4 * q,
                        fwd, c.p);
        else
#endif
          run_pass<false>(pass_stages(LOG_N, q), xr[i], tid + i * T,
                          pass_ls(LOG_N, q), 4 * q, fwd, c.p);
      }
    }
    const size_t row = ((size_t)s * n_primes + pr) * rows + r;
    store_spectrum<G, T, PACK>(xr, out + row * n,
                               PACK ? out_sh + row * n : nullptr, c,
                               buf + 2 * n);
  }
}

// N = 4 or 8, fewer residues than one group (no size the CRT-NTT path
// packs): one thread per (polynomial, prime) runs every stage, the
// butterflies of ops/ntt.py ntt_forward_plain in its order.
template <int LOG_N>
__global__ void ntt_forward_tiny(const long long* __restrict__ x,
                                 uint32_t* __restrict__ out,
                                 const uint2* __restrict__ tw,
                                 const uint32_t* __restrict__ consts,
                                 int polys) {
  constexpr int n = 1 << LOG_N;
  const int m = blockIdx.x * blockDim.x + threadIdx.x, pr = blockIdx.y;
  if (m >= polys) return;
  const Reduce c = reduce_of(consts + 8 * pr);
  const uint2* fwd = tw + (size_t)pr * 2 * n;
  uint32_t a[n];
#pragma unroll
  for (int j = 0; j < n; ++j) a[j] = residue(x[(size_t)m * n + j], c);
#pragma unroll
  for (int h = 1, t = n / 2; h < n; h *= 2, t /= 2)
#pragma unroll
    for (int i = 0; i < h; ++i)
#pragma unroll
      for (int j = 2 * i * t; j < 2 * i * t + t; ++j) {
        const uint2 w = __ldg(fwd + h + i);
        ntt::ct_butterfly(a[j], a[j + t], w.x, w.y, c.p);
      }
#pragma unroll
  for (int j = 0; j < n; ++j) out[((size_t)pr * polys + m) * n + j] = a[j];
}

template <int LOG_N, bool PACK>
cudaError_t launch(const void* x, void* out, void* out_sh, const void* tw,
                   const void* consts, int polys, int rows, int n_primes,
                   int shift, void* stream) {
  constexpr int G = LOG_N == 14 ? 2 : 1;
  const int smem = (int)(3 * sizeof(uint32_t)) << LOG_N;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_forward_kernel<LOG_N, PACK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ntt_forward_kernel<LOG_N, PACK>
      <<<polys, (1 << LOG_N) / (E * G), smem, (cudaStream_t)stream>>>(
          (const long long*)x, (uint32_t*)out, (uint32_t*)out_sh,
          (const uint2*)tw, (const uint32_t*)consts, rows, n_primes, shift);
  return cudaGetLastError();
}

template <int LOG_N>
cudaError_t launch_tiny(const void* x, void* out, const void* tw,
                        const void* consts, int polys, int n_primes,
                        void* stream) {
  const dim3 grid((unsigned)((polys + 127) / 128), (unsigned)n_primes);
  ntt_forward_tiny<LOG_N><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const long long*)x, (uint32_t*)out, (const uint2*)tw,
      (const uint32_t*)consts, polys);
  return cudaGetLastError();
}

}  // namespace

// x (M, N) int64 -> out (P, M, N) u32, bit-reversed spectra; tw the paired
// tables of ops/ntt.py pair_tables (P, 2, N) pairs, consts (P, 8) u32.
// N = 2^log_n, 4 <= N <= 16384.
extern "C" int ntt_forward(const void* x, void* out, const void* tw,
                           const void* consts, int polys, int n_primes,
                           int log_n, void* stream) {
#define NTT_FWD_CASE(L)                                                    \
  case L:                                                                  \
    return (int)launch<L, false>(x, out, nullptr, tw, consts, polys,       \
                                 polys, n_primes, 0, stream);
  switch (log_n) {
    case 2: return (int)launch_tiny<2>(x, out, tw, consts, polys, n_primes,
                                       stream);
    case 3: return (int)launch_tiny<3>(x, out, tw, consts, polys, n_primes,
                                       stream);
    NTT_FWD_CASE(4) NTT_FWD_CASE(5) NTT_FWD_CASE(6) NTT_FWD_CASE(7)
    NTT_FWD_CASE(8) NTT_FWD_CASE(9) NTT_FWD_CASE(10) NTT_FWD_CASE(11)
    NTT_FWD_CASE(12) NTT_FWD_CASE(13) NTT_FWD_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NTT_FWD_CASE
}

// The key pack: x (n_small rows, N) int64, the u64 key's polynomials as
// uploaded (rows per step), each >> shift; spec and spec_sh (n_small,
// P rows, N) u32.  N = 2^log_n, 256 <= N <= 16384.
extern "C" int ntt_forward_pack(const void* x, void* spec, void* spec_sh,
                                const void* tw, const void* consts, int polys,
                                int rows, int n_primes, int log_n, int shift,
                                void* stream) {
#define NTT_PACK_CASE(L)                                                   \
  case L:                                                                  \
    return (int)launch<L, true>(x, spec, spec_sh, tw, consts, polys, rows, \
                                n_primes, shift, stream);
  switch (log_n) {
    NTT_PACK_CASE(8) NTT_PACK_CASE(9) NTT_PACK_CASE(10) NTT_PACK_CASE(11)
    NTT_PACK_CASE(12) NTT_PACK_CASE(13) NTT_PACK_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NTT_PACK_CASE
}
