// The negacyclic NTT held in registers: the transform schedule shared by
// kernel 2 (csrc/ntt.cu, csrc/ntt_inverse.cu: the standalone transforms
// and the key pack) and kernel 3 (csrc/crt_external_product.cuh: the
// blind-rotate step).  The butterflies are those of csrc/ntt.cuh, so both
// compute the same integers as the plain versions in ops/ntt.py.
//
// Each of N/16 groups holds 16 residues in one thread's registers and runs
// up to 4 radix-2 stages on them between exchanges (a "pass"), so a
// transform of N = 4096 takes 3 passes and 2 exchanges through shared
// memory, one barrier each (two buffers alternate).  Pass q's 16 residues
// of group g sit at stride 2^ls, ls = log2 N - 4q - 4 (clamped at 0): the
// first pass reads its input and the inverse's last writes its output,
// both coalesced; the last forward pass leaves residues 16g..16g+15 of the
// bit-reversed spectrum in group g, which is where the inverse's first
// pass starts.  The exchange buffer is swizzled, index j at
// j ^ ((j >> 4) & 31), which makes every pass's loads and stores free of
// bank conflicts.  The twiddles are paired with their Shoup companions
// (one 8-byte load each, ops/ntt.py pair_tables), loaded at each
// butterfly; a pass's 32 butterflies read 15 distinct pairs, so all but
// the first load of each hit L1.  A block runs N / (16 G) threads of G
// groups each, group i of thread t being t + i * blockDim.x.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

constexpr int E = 16;          // residues per thread per group

// Threads of a block that holds one size-2^log_n polynomial: one group
// each, two at N = 16384 (512 threads).
constexpr int threads_of(int log_n) {
  return (1 << log_n) / (E * (log_n == 14 ? 2 : 1));
}

// Kernel 2's blocks per SM for __launch_bounds__, which caps a thread's
// registers near `regs` at N = 1024 .. 4096 (64 to 256 threads a block):
// left alone the compiler takes far more and fits fewer blocks.  Above,
// 512 threads a block cap them at 128 already; below, a block is a warp
// or less.
constexpr int min_blocks_of(int log_n, int regs) {
  return log_n < 10 || log_n > 12 ? 1 : 65536 / (regs * threads_of(log_n));
}

// Exchange-buffer slot of index j (a bijection on each 512-word block).
__device__ __forceinline__ int swz(int j) { return j ^ ((j >> 4) & 31); }

// Index of residue k of group g in a pass whose groups have stride 2^ls.
__device__ __forceinline__ int pos(int g, int ls, int k) {
  return ((g >> ls) << (ls + 4)) + (g & ((1 << ls) - 1)) + (k << ls);
}

// R radix-2 stages s0 .. s0+R-1 on one group in registers: forward
// Cooley-Tukey (INV false) or, in reverse stage order, inverse
// Gentleman-Sande.  Stage s0+q pairs residues k and k + 2^(R-1-q) and
// reads twiddle m + (j >> (log2 N - s0 - q)) = 2^(s0+q) + (blk << (4-R+q))
// + (k >> (R-q)) for blk = g >> ls: 2^(4-R+q) distinct pairs per stage.
template <int R, bool INV>
__device__ __forceinline__ void pass(uint32_t (&x)[E], int g, int ls,
                                     int s0, const uint2* __restrict__ tw,
                                     uint32_t p) {
  const int blk = g >> ls;
#pragma unroll
  for (int qq = 0; qq < R; ++qq) {
    const int q = INV ? R - 1 - qq : qq;
    const int base = (1 << (s0 + q)) + (blk << (4 - R + q));
    const int dk = 1 << (R - 1 - q);
#ifdef ABLATE_TWIDDLE_GATHER
    uint2 w[8];
#pragma unroll
    for (int c = 0; c < (1 << (4 - R + q)); ++c) w[c] = __ldg(tw + base + c);
#endif
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (k & dk) continue;
#ifdef ABLATE_TWIDDLE_GATHER
      const uint2 s = w[k >> (R - q)];
#else
      // each butterfly loads its pair (an L1 hit after the first): fewer
      // live registers than a stage's pairs gathered up front
      const uint2 s = __ldg(tw + base + (k >> (R - q)));
#endif
      if (INV)
        ntt::gs_butterfly(x[k], x[k + dk], s.x, s.y, p);
      else
        ntt::ct_butterfly(x[k], x[k + dk], s.x, s.y, p);
    }
  }
}

template <bool INV>
__device__ __forceinline__ void run_pass(int r, uint32_t (&x)[E], int g,
                                         int ls, int s0,
                                         const uint2* __restrict__ tw,
                                         uint32_t p) {
  switch (r) {
    case 4: pass<4, INV>(x, g, ls, s0, tw, p); break;
    case 3: pass<3, INV>(x, g, ls, s0, tw, p); break;
    case 2: pass<2, INV>(x, g, ls, s0, tw, p); break;
    default: pass<1, INV>(x, g, ls, s0, tw, p); break;
  }
}

// Stride exponent and stage count of pass q of a size-2^log_n transform.
__device__ __forceinline__ int pass_ls(int log_n, int q) {
  const int ls = log_n - 4 * q - 4;
  return ls > 0 ? ls : 0;
}
__device__ __forceinline__ int pass_stages(int log_n, int q) {
  const int r = log_n - 4 * q;
  return r < 4 ? r : 4;
}

// Move G groups from pass `from`'s layout to pass `to`'s through the
// next exchange buffer: one barrier.  (ABLATE_NO_EXCHANGE, set only by
// tools/ablate_kernels.py's kernel-2 builds, leaves the residues where
// they are: a timing of the passes without their exchanges.)
template <int G>
__device__ __forceinline__ void exchange(uint32_t (&x)[G][E], uint32_t* buf,
                                         int n, int& ex, int log_n, int from,
                                         int to) {
#ifndef ABLATE_NO_EXCHANGE
  uint32_t* b = buf + (ex++ & 1) * n;
  const int ls_from = pass_ls(log_n, from), ls_to = pass_ls(log_n, to);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int k = 0; k < E; ++k) b[swz(pos(g, ls_from, k))] = x[i][k];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int k = 0; k < E; ++k) x[i][k] = b[swz(pos(g, ls_to, k))];
  }
#endif
}

// The inverse transform of one polynomial held as G groups of 16
// bit-reversed spectrum residues per thread, scaled by 1/N and stored
// at the first pass's (coalesced) positions of row dst.
template <int G, int LOG_N>
__device__ __forceinline__ void inverse_store(
    uint32_t (&x)[G][E], uint32_t* buf, int& ex,
    const uint2* __restrict__ inv, uint32_t p, uint32_t n_inv,
    uint32_t n_inv_sh, uint32_t* __restrict__ dst) {
  constexpr int n = 1 << LOG_N, npass = (LOG_N + 3) / 4;
#pragma unroll
  for (int q = npass - 1; q >= 0; --q) {
    if (q < npass - 1) exchange<G>(x, buf, n, ex, LOG_N, q + 1, q);
#pragma unroll
    for (int i = 0; i < G; ++i)
      run_pass<true>(pass_stages(LOG_N, q), x[i],
                     threadIdx.x + i * blockDim.x, pass_ls(LOG_N, q), 4 * q,
                     inv, p);
  }
  const int ls0 = pass_ls(LOG_N, 0);
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int g = threadIdx.x + i * blockDim.x;
#ifdef ABLATE_NO_STORE
    // kernel 2's timing without its stores: a sink the compiler keeps
    // (residues are below p < 2^31, so it never stores)
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < E; ++k)
      s ^= ntt::shoup_mul(x[i][k], n_inv, n_inv_sh, p);
    if (s == 0xFFFFFFFFu) dst[g] = s;
#else
#pragma unroll
    for (int k = 0; k < E; ++k)
      dst[pos(g, ls0, k)] = ntt::shoup_mul(x[i][k], n_inv, n_inv_sh, p);
#endif
  }
}

}  // namespace
