// Kernel 4's per-coefficient arithmetic as device functions: the
// explicit-CRT recombination of the external product's residues, and the
// accumulator update in its two modes.  Two kernels include it with the
// same arithmetic: csrc/garner_accumulate.cu (kernel 4, one coefficient
// per thread over the whole accumulator) and
// csrc/blind_rotate_fused_latency.cu (every step of a B <= 4 blind rotate,
// the residues read from the cluster's blocks).
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
// The constants (ops/fused_ntt.py garner_constants) are an array of u64:
// per prime PER_PRIME words, then P, H and top32(H << t), all mod 2^64.

#pragma once

#include <cstdint>

#include "ntt.cuh"

namespace garner {

// per prime: p, inv, inv_sh, hinv, m64, bits of (double) 1/p; then
// P mod 2^64, H mod 2^64, top32((H << t) mod 2^64)
constexpr int PER_PRIME = 6;

// Adds residue r of prime i (its constants at c = cst + PER_PRIME i) to
// the sums w (mod 2^64) and frac.
__device__ __forceinline__ void add_residue(
    unsigned long long& w, double& frac, uint32_t r,
    const unsigned long long* __restrict__ c) {
  const uint32_t p = (uint32_t)__ldg(c);
  const uint32_t ci = ntt::add_mod(
      ntt::shoup_mul(r, (uint32_t)__ldg(c + 1), (uint32_t)__ldg(c + 2), p),
      (uint32_t)__ldg(c + 3), p);
  w += (unsigned long long)ci * __ldg(c + 4);
  frac += (double)ci * __longlong_as_double((long long)__ldg(c + 5));
}

// w = z + H from the sums over every prime, p64 = P mod 2^64.
__device__ __forceinline__ unsigned long long recombined(
    unsigned long long w, double frac, unsigned long long p64) {
  return w - (unsigned long long)frac * p64;
}

// The acc32 mode's update of a top word, htop = top32((H << t) mod 2^64).
__device__ __forceinline__ uint32_t add_top(uint32_t acc,
                                            unsigned long long w, int shift,
                                            uint32_t htop) {
  return acc + ((uint32_t)((w << shift) >> 32) - htop);
}

// The full mode's update of a u64 coefficient, h64 = H mod 2^64.
__device__ __forceinline__ unsigned long long add_full(
    unsigned long long acc, unsigned long long w, int shift,
    unsigned long long h64) {
  return acc + ((w - h64) << shift);
}

}  // namespace garner
