// Kernel 3 of the CRT-NTT path: one blind-rotate step's external product
// of the gadget digits with the bootstrap key, per CRT prime, exactly.  The
// kernel template; csrc/crt_external_product.cu compiles it for k+1 = 2
// (the entry point) and csrc/crt_external_product_wide.cu for k+1 >= 3,
// in two nvcc processes that run side by side.
//
// Replaces the core of the TPU kernel concrete_tpu/ops/pallas_fused_ntt.py
// blind_rotate_fused (:1223; _step_kernel :1018-1143: forward transforms,
// the spectral multiply-accumulate with the BSK spectra, inverse
// transforms).  The TPU kernel keeps the whole n_small-step scan in one
// pallas_call because its grid runs in order and VMEM holds the
// accumulator; on Hopper the blocks of a launch run in no order, so the
// scan is a host loop of three launches per step (ops/fused_ntt.py) and
// this kernel is the middle one.
//
// For ciphertext b and prime p (one block each), with Cin = levels * (k+1):
//   acc[co] = sum_{ci < Cin} NTT(d[ci] mod p) (.) S[p, ci, co]   (mod p)
//   out[p][b*(k+1) + co] = INTT(acc[co])                          (k+1 rows)
// d[ci] = digits[lev][b*(k+1) + comp] for ci = lev*(k+1) + comp, the
// signed gadget digits of csrc/rotate_decompose.cu; S is one step of the
// packed BSK spectra (P, Cin, k+1, N) in the forward's bit-reversed order,
// with Shoup companions.  The residues are those of the exact integer
// external product z (|z| <= P/4 by required_bits), which kernel 4
// (csrc/garner_accumulate.cu) recombines.
//
// Bound: operations.  Per step (Cin + k + 1) transforms of (N/2) log2 N
// butterflies per (ciphertext, prime), plus Cin (k+1) N Shoup
// multiply-adds; the digits (4 B), key spectra (8 B) and residues (4 B)
// per coefficient are far fewer bytes.  The butterflies are those of
// csrc/ntt.cuh (ct_butterfly, gs_butterfly, mul_add), so the transform
// computes the same integers as ntt_forward / ntt_inverse.  What the
// design spends beside them is the schedule, and it keeps that small:
//  - registers, not shared memory, carry the transform (the schedule of
//    csrc/ntt_regs.cuh, which kernel 2 shares): each of N/16
//    threads holds 16 residues and runs up to 4 radix-2 stages on them
//    between exchanges (a "pass"), so a transform of N = 4096 takes 3
//    passes and 2 exchanges through shared memory, one barrier each (two
//    buffers alternate), where the radix-2 schedule took 12 round trips;
//  - pass q's 16 residues of group g sit at stride 2^ls, ls = log2 N -
//    4q - 4 (clamped at 0): the first pass reads the digits from global
//    memory and the inverse's last writes the residues, both coalesced;
//    the last forward pass leaves residues 16g..16g+15 of the bit-reversed
//    spectrum in thread g, which is where the multiply-add reads the key
//    (four 16-byte loads per polynomial) and where the inverse's first pass
//    starts, so neither needs an exchange;
//  - the exchange buffer is swizzled, index j at j ^ ((j >> 4) & 31), which
//    makes every pass's loads and stores free of bank conflicts;
//  - the twiddles are paired with their Shoup companions (one 8-byte load
//    each, ops/ntt.py pair_tables), loaded at each butterfly; a
//    pass's 32 butterflies read 15 distinct pairs, so all but the first
//    load of each hit L1, and no stage holds its pairs in registers;
//  - the first KR = 2 of the k+1 accumulators live in registers across the
//    Cin digit polynomials; any further ones (k >= 2) in shared memory
//    beside the exchange buffers, in slots only their own thread touches
//    (residue k of thread t at k * threads + t: conflict-free, no
//    barrier).  Shared memory is then (k+1) N 4 bytes, at most 227 KB:
//    k+1 <= 3 at N = 16384, <= 7 at N = 8192, more below
//    (ops/fused_ntt.py checks it when the key is packed).  Beyond that,
//    the k+1 output components are split into groups (kernel_groups in
//    ops/fused_ntt.py): blockIdx.z is the group, each block holds the
//    accumulators of its group only and recomputes the digits' forward
//    transforms, so any k+1 runs (k+1 = 4 at N = 16384 in two groups of
//    two, both in registers; k+1 = 8 at N = 8192 in two groups of four);
//    a cluster sharing the accumulators through distributed shared memory
//    would need a barrier per digit polynomial.
// N = 16384 runs 512 threads of two groups each; N <= 8192 one group.  The
// kernel is compiled once per N (log2 N in 10 .. 14), so every pass's
// strides, twiddle offsets and exchange addresses are constants, and twice
// per N: for k+1 = 2 (WIDE false, the common case: nothing in shared
// memory but the exchanges, 128 registers and no spills at N = 4096) and
// for any k+1 >= 3 (WIDE, k+1 an argument).  What is left above the bound
// (PERF.md): the exchanges' index math and barriers, the twiddle loads,
// two blocks of 8 warps per SM (128 registers), and each block's reading
// of the step's key spectra, 201 MB of L2 traffic per launch at the MLP
// shape.  tools/ablate_kernels.py times those parts through the ABLATE_*
// switches below, which only its builds set.
//
// The runtime-key entry (KEYED, csrc/crt_external_product_keyed.cu) is the
// same kernel with one more input: an int32 key index per ciphertext into a
// stack of per-ciphertext spectra (n_keys, P * Cin * (k+1), N), where the
// BSK entry reads one step's spectra for every ciphertext.  The WoP
// vertical packing multiplies by the circuit bootstrap's GGSWs this way
// (core/kernels_wop.py): their layout is a BSK step's, kernel 2's pack
// entry transforms them, and ciphertext b reads key key_index[b].  Every
// ciphertext reads its own Cin (k+1) N spectra and companions per prime
// (8 bytes a coefficient) beside the (Cin + k + 1) (N/2) log2 N
// butterflies.  It is compiled for N = 256 .. 16384 (the WoP circuits'
// N = 256 and 512 included); the BSK entry's instantiations do not
// change.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_regs.cuh"

namespace {

constexpr int KR = 2;          // accumulators held in registers
constexpr int MAX_THREADS = 512;

// acc[k] += x[k] * key[j0 + k] (mod p) for the 16 residues j0 .. j0+15 of
// one group: four 16-byte loads of the key and of its companions.
__device__ __forceinline__ void mac16(uint32_t (&acc)[E],
                                      const uint32_t (&x)[E],
                                      const uint32_t* __restrict__ kv_row,
                                      const uint32_t* __restrict__ ks_row,
                                      int j0, uint32_t p) {
  const uint4* kv = reinterpret_cast<const uint4*>(kv_row + j0);
  const uint4* ks = reinterpret_cast<const uint4*>(ks_row + j0);
#pragma unroll
  for (int v = 0; v < E / 4; ++v) {
#ifdef ABLATE_NO_KEY_LOADS
    const uint4 kw = make_uint4(j0, v, 5, 7), sw = make_uint4(v, j0, 3, 1);
#else
    const uint4 kw = __ldg(kv + v), sw = __ldg(ks + v);
#endif
    uint32_t* a = acc + 4 * v;
    const uint32_t* xv = x + 4 * v;
    a[0] = ntt::mul_add(a[0], xv[0], kw.x, sw.x, p);
    a[1] = ntt::mul_add(a[1], xv[1], kw.y, sw.y, p);
    a[2] = ntt::mul_add(a[2], xv[2], kw.z, sw.z, p);
    a[3] = ntt::mul_add(a[3], xv[3], kw.w, sw.w, p);
  }
}

template <int G, int LOG_N, bool WIDE, bool KEYED = false>
__global__ void __launch_bounds__(MAX_THREADS) crt_external_product_kernel(
    const int32_t* __restrict__ digits, const uint32_t* __restrict__ spec,
    const uint32_t* __restrict__ spec_sh, uint32_t* __restrict__ out,
    const uint2* __restrict__ tw, const uint32_t* __restrict__ consts,
    int batch, int levels, int kp1_arg, int co_group,
    const int32_t* __restrict__ key_index) {
  const int kp1 = WIDE ? kp1_arg : KR;
  // this block's output components co0 .. co0+ng-1 (WIDE: a group of
  // co_group, blockIdx.z the group; else both of k+1 = 2)
  const int co0 = WIDE ? (int)blockIdx.z * co_group : 0;
  const int ng = WIDE ? min(co_group, kp1 - co0) : KR;
  // [2][N] exchange buffers (swizzled), then [ng-KR][N] accumulators
  extern __shared__ uint32_t buf[];
  constexpr int log_n = LOG_N, n = 1 << LOG_N, npass = (LOG_N + 3) / 4;
  constexpr int T = n / (E * G);             // threads per block
  const int b = blockIdx.x, pr = blockIdx.y, tid = threadIdx.x;
  const int rows = batch * kp1, cin = levels * kp1;
  const uint32_t p = consts[3 * pr];
  if constexpr (KEYED) {
    // ciphertext b's own key: a stack entry of P * Cin * (k+1) rows
    const size_t step = (size_t)__ldg(key_index + b) * gridDim.y * cin *
                        kp1 << LOG_N;
    spec += step;
    spec_sh += step;
  }
  const uint2* fwd = tw + (size_t)pr * 2 * n;
  const uint2* inv = fwd + n;
  // residue k of group i of accumulator KR + c: slot ((c G + i) E + k) T
  // + tid, this thread's alone
  uint32_t* acc_sh = buf + 2 * n + tid;
  int ex = 0;

  uint32_t acc[KR][G][E];
#pragma unroll
  for (int co = 0; co < KR; ++co)
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int k = 0; k < E; ++k) acc[co][i][k] = 0;
  for (int c = 0; c < (ng - KR) * G * E; ++c) acc_sh[c * T] = 0;

  for (int ci = 0; ci < cin; ++ci) {
    const int lev = ci / kp1, comp = ci - lev * kp1;
    const int32_t* src = digits + ((size_t)lev * rows + b * kp1 + comp) * n;
    uint32_t x[G][E];
    const int ls0 = pass_ls(log_n, 0);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int g = tid + i * T;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int32_t d = __ldg(src + pos(g, ls0, k));   // |d| < p
        x[i][k] = d < 0 ? (uint32_t)(d + (int32_t)p) : (uint32_t)d;
      }
      pass<4, false>(x[i], g, ls0, 0, fwd, p);
    }
#pragma unroll
    for (int q = 1; q < npass; ++q) {
      exchange<G>(x, buf, n, ex, log_n, q - 1, q);
#pragma unroll
      for (int i = 0; i < G; ++i)
        run_pass<false>(pass_stages(log_n, q), x[i], tid + i * T,
                        pass_ls(log_n, q), 4 * q, fwd, p);
    }
    // thread g now holds spectrum residues 16g .. 16g+15 of each group
    const size_t key = (size_t)(pr * cin + ci) * kp1 * n;
#pragma unroll
    for (int co = 0; co < KR; ++co) {
      if (WIDE && co >= ng) break;
#pragma unroll
      for (int i = 0; i < G; ++i)
        mac16(acc[co][i], x[i], spec + key + (size_t)(co0 + co) * n,
              spec_sh + key + (size_t)(co0 + co) * n, E * (tid + i * T), p);
    }
    for (int co = KR; co < ng; ++co) {
      uint32_t* sh = acc_sh + (size_t)(co - KR) * n;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        uint32_t a[E];
#pragma unroll
        for (int k = 0; k < E; ++k) a[k] = sh[(i * E + k) * T];
        mac16(a, x[i], spec + key + (size_t)(co0 + co) * n,
              spec_sh + key + (size_t)(co0 + co) * n, E * (tid + i * T), p);
#pragma unroll
        for (int k = 0; k < E; ++k) sh[(i * E + k) * T] = a[k];
      }
    }
  }

  const uint32_t n_inv = consts[3 * pr + 1], n_inv_sh = consts[3 * pr + 2];
  uint32_t* dst = out + ((size_t)pr * rows + (size_t)b * kp1 + co0) * n;
#pragma unroll
  for (int co = 0; co < KR; ++co) {
    if (WIDE && co >= ng) break;
    inverse_store<G, LOG_N>(acc[co], buf, ex, inv, p, n_inv, n_inv_sh,
                            dst + (size_t)co * n);
  }
  for (int co = KR; co < ng; ++co) {
    const uint32_t* a = acc_sh + (size_t)(co - KR) * n;
    uint32_t x[G][E];
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int k = 0; k < E; ++k) x[i][k] = a[(i * E + k) * T];
    inverse_store<G, LOG_N>(x, buf, ex, inv, p, n_inv, n_inv_sh,
                            dst + (size_t)co * n);
  }
}

template <int LOG_N, bool WIDE, bool KEYED = false>
cudaError_t launch(const void* digits, const void* spec, const void* spec_sh,
                   void* out, const void* tw, const void* consts, int batch,
                   int levels, int kp1, int n_primes, int co_group,
                   void* stream, const void* key_index = nullptr) {
  constexpr int G = LOG_N == 14 ? 2 : 1;   // 1024 groups: 512 threads of 2
  const int in_smem = co_group > KR ? co_group - KR : 0;
  const int smem = (int)(sizeof(uint32_t) * (size_t)(2 + in_smem) << LOG_N);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        crt_external_product_kernel<G, LOG_N, WIDE, KEYED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)batch, (unsigned)n_primes,
                  (unsigned)((kp1 + co_group - 1) / co_group));
  crt_external_product_kernel<G, LOG_N, WIDE, KEYED>
      <<<grid, (1 << LOG_N) / (E * G), smem, (cudaStream_t)stream>>>(
          (const int32_t*)digits, (const uint32_t*)spec,
          (const uint32_t*)spec_sh, (uint32_t*)out, (const uint2*)tw,
          (const uint32_t*)consts, batch, levels, kp1, co_group,
          (const int32_t*)key_index);
  return cudaGetLastError();
}

// The kernel for k+1 = 2 (WIDE false: one group of both components) or
// k+1 >= 3 at N = 2^log_n, in groups of co_group output components.
template <bool WIDE>
int launch_n(const void* digits, const void* spec, const void* spec_sh,
             void* out, const void* tw, const void* consts, int batch,
             int levels, int kp1, int n_primes, int log_n, int co_group,
             void* stream) {
  if (WIDE ? kp1 <= KR || co_group < 1 || co_group > kp1
           : kp1 != KR || co_group != KR)
    return (int)cudaErrorInvalidValue;
#define CRT_XP_CASE(L)                                                      \
  case L:                                                                   \
    return (int)launch<L, WIDE>(digits, spec, spec_sh, out, tw, consts,     \
                                batch, levels, kp1, n_primes, co_group,   \
                                stream);
  switch (log_n) {
    CRT_XP_CASE(10) CRT_XP_CASE(11) CRT_XP_CASE(12) CRT_XP_CASE(13)
    CRT_XP_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CRT_XP_CASE
}

}  // namespace

// csrc/crt_external_product_wide.cu: launch_n<true>, for k+1 >= 3.
extern "C" int crt_external_product_wide(const void* digits, const void* spec,
                                         const void* spec_sh, void* out,
                                         const void* tw, const void* consts,
                                         int batch, int levels, int kp1,
                                         int n_primes, int log_n,
                                         int co_group, void* stream);
