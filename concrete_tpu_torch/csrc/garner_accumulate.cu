// Kernel 4 of the CRT-NTT path: explicit-CRT recombination of the external
// product's residues, shifted by the BSK truncation and added into the
// accumulator in place.
//
// Replaces the tail of the TPU kernel concrete_tpu/ops/pallas_fused_ntt.py
// blind_rotate_fused (:1223; _garner_prefolded :622-677 and the
// accumulator update :1121-1142).  The TPU emulates every 64-bit step with
// u32 pairs; here it is native u64 arithmetic.
//
// The arithmetic per coefficient (the explicit CRT, exact, and the two
// modes' updates) is in csrc/garner.cuh, which the B <= 4 CRT-NTT blind
// rotate (csrc/blind_rotate_fused_latency.cu) shares.
//
// Bound: bytes.  Per coefficient it reads P u32 residues and reads and
// writes the accumulator (8 or 4 bytes), with a few dozen integer
// operations.  Design: a grid-stride loop, one coefficient per thread per
// iteration, consecutive threads on consecutive addresses; the per-prime
// constants come from a small array through the read-only cache, and the
// prime count is a run-time loop that keeps no per-prime array.

#include <cstdint>
#include <cuda_runtime.h>

#include "garner.cuh"

namespace {

using garner::PER_PRIME;

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
    for (int i = 0; i < n_primes; ++i)
      garner::add_residue(w, frac, res[(size_t)i * elems + e],
                          cst + PER_PRIME * i);
    w = garner::recombined(w, frac, p64);
    if (ACC32) {
      uint32_t* a = (uint32_t*)acc;
      a[e] = garner::add_top(a[e], w, shift, htop);
    } else {
      unsigned long long* a = (unsigned long long*)acc;
      a[e] = garner::add_full(a[e], w, shift, h64);
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
