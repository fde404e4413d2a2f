// Negacyclic NTT mod one prime p < 2^31: the modular arithmetic shared by
// csrc/ntt_regs.cuh (the register-resident transform schedule of kernels 2
// and 3), the kernels themselves and the probes of csrc/op_probes.cu.
//
// Forward: Cooley-Tukey with the psi twists merged into the twiddles
// (tw[m + i] = psi^bitrev(m + i)), natural order in, bit-reversed order out.
// Inverse: Gentleman-Sande with psi^-bitrev twiddles, bit-reversed in,
// natural order out, then the 1/N scaling.  No permutation pass is needed
// anywhere: the pointwise product does not care about the order.
//
// Residues are canonical u32 in [0, p).  Every modular product is Shoup's:
// with w < p and w' = floor(w * 2^32 / p), for any a < 2^32,
//   q = umulhi(a, w'),  r = a * w - q * p  (mod 2^32)  lies in [0, 2p),
// one conditional subtraction makes it canonical: three 32-bit multiplies
// and no 64-bit division.  p < 2^31 keeps 2p and every sum below 2^32.

#pragma once

#include <cstdint>

namespace ntt {

__device__ __forceinline__ uint32_t reduce_once(uint32_t x, uint32_t p) {
  return x >= p ? x - p : x;
}

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t w,
                                              uint32_t w_sh, uint32_t p) {
  const uint32_t q = __umulhi(a, w_sh);
  return reduce_once(a * w - q * p, p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return reduce_once(a + b, p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t p) {
  return reduce_once(a + p - b, p);
}

// The operations the transforms and the pointwise product repeat; the
// probes in csrc/op_probes.cu count their instructions.
// Cooley-Tukey: (u, v) <- (u + s v, u - s v).
__device__ __forceinline__ void ct_butterfly(uint32_t& u, uint32_t& v,
                                             uint32_t s, uint32_t s_sh,
                                             uint32_t p) {
  const uint32_t sv = shoup_mul(v, s, s_sh, p);
  v = sub_mod(u, sv, p);
  u = add_mod(u, sv, p);
}

// Gentleman-Sande: (u, v) <- (u + v, s (u - v)).
__device__ __forceinline__ void gs_butterfly(uint32_t& u, uint32_t& v,
                                             uint32_t s, uint32_t s_sh,
                                             uint32_t p) {
  const uint32_t d = sub_mod(u, v, p);
  u = add_mod(u, v, p);
  v = shoup_mul(d, s, s_sh, p);
}

// acc + x k (mod p), k' the Shoup companion of k.
__device__ __forceinline__ uint32_t mul_add(uint32_t acc, uint32_t x,
                                            uint32_t k, uint32_t k_sh,
                                            uint32_t p) {
  return add_mod(acc, shoup_mul(x, k, k_sh, p), p);
}

}  // namespace ntt
