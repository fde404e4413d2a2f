// Kernel 4 of the CRT-NTT path: explicit-CRT recombination of the external
// product's residues, shifted by the BSK truncation and added into the
// accumulator in place.
//
// Replaces the tail of the TPU kernel concrete_tpu/ops/pallas_fused_ntt.py
// blind_rotate_fused (:1223; _garner_prefolded :622-677 and the
// accumulator update :1121-1142).  The TPU emulates every 64-bit step with
// u32 pairs; here it is native u64 arithmetic.
//
// From the residues r_i = z mod p_i of the signed exact product z
// (|z| <= P/4, P = prod p_i, H = (P - 1) / 2, M_i = P / p_i):
//   c_i = (r_i + H) M_i^-1 mod p_i            (a Shoup multiply and an add)
//   k   = floor(sum_i c_i / p_i)              (double precision, see below)
//   w   = sum_i c_i M_i - k P  (mod 2^64)     = z + H exactly, in [0, P)
// and then, with t the BSK truncation shift:
//   full mode:  acc (u64)  += (w - H) << t = z << t            (mod 2^64)
//   acc32 mode: acc (u32)  += top32((w << t) mod 2^64) - top32(H << t)
// the second being the JAX package's hi-only accumulator semantics
// (pallas_fused_ntt.py:666-674, blind_rotate_acc32_oracle :1171-1220).
//
// k is exact: sum_i c_i / p_i = w / P + k lies at least 1/4 from every
// integer because w = z + H is within P/4 of P/2; each term's double
// rounding errs by under 2^-52 of it, far inside that margin.
//
// Bound: bytes.  Per coefficient it reads P u32 residues and reads and
// writes the accumulator (8 or 4 bytes), with a few dozen integer
// operations.  Design: a grid-stride loop, one coefficient per thread per
// iteration, consecutive threads on consecutive addresses; the per-prime
// constants come from a small array through the read-only cache, and the
// prime count is a run-time loop that keeps no per-prime array.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

// per prime: p, inv, inv_sh, hinv, m64, bits of (double) 1/p; then
// P mod 2^64, H mod 2^64, top32((H << t) mod 2^64)
constexpr int PER_PRIME = 6;

template <bool ACC32>
__global__ void garner_accumulate_kernel(
    const uint32_t* __restrict__ res, void* __restrict__ acc,
    const unsigned long long* __restrict__ cst, int n_primes,
    long long elems, int shift) {
  const unsigned long long p64 = cst[PER_PRIME * n_primes];
  const unsigned long long h64 = cst[PER_PRIME * n_primes + 1];
  const uint32_t htop = (uint32_t)cst[PER_PRIME * n_primes + 2];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < elems; e += (long long)gridDim.x * blockDim.x) {
    unsigned long long w = 0;
    double frac = 0.0;
    for (int i = 0; i < n_primes; ++i) {
      const unsigned long long* c = cst + PER_PRIME * i;
      const uint32_t p = (uint32_t)__ldg(c);
      const uint32_t r = res[(size_t)i * elems + e];
      const uint32_t ci = ntt::add_mod(
          ntt::shoup_mul(r, (uint32_t)__ldg(c + 1), (uint32_t)__ldg(c + 2),
                         p),
          (uint32_t)__ldg(c + 3), p);
      w += (unsigned long long)ci * __ldg(c + 4);
      frac += (double)ci * __longlong_as_double((long long)__ldg(c + 5));
    }
    w -= (unsigned long long)frac * p64;
    if (ACC32) {
      uint32_t* a = (uint32_t*)acc;
      a[e] += (uint32_t)((w << shift) >> 32) - htop;
    } else {
      unsigned long long* a = (unsigned long long*)acc;
      a[e] += (w - h64) << shift;
    }
  }
}

}  // namespace

extern "C" int garner_accumulate(const void* res, void* acc,
                                 const void* constants, int n_primes,
                                 long long elems, int shift, int acc32,
                                 void* stream) {
  const int threads = 256;
  long long blocks = (elems + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  const unsigned long long* cst = (const unsigned long long*)constants;
  if (acc32)
    garner_accumulate_kernel<true><<<(unsigned)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
        (const uint32_t*)res, acc, cst, n_primes, elems, shift);
  else
    garner_accumulate_kernel<false><<<(unsigned)blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
        (const uint32_t*)res, acc, cst, n_primes, elems, shift);
  return (int)cudaGetLastError();
}
