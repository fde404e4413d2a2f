// Negacyclic NTT mod one prime p < 2^31, in shared memory: the device code
// shared by csrc/ntt.cu (standalone transforms) and
// csrc/crt_external_product.cu (the blind-rotate step).
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

// Signed 64-bit integer -> canonical residue mod p (once per input, not in
// the butterflies).
__device__ __forceinline__ uint32_t residue_i64(long long x, uint32_t p) {
  const unsigned long long mag =
      x < 0 ? 0ULL - (unsigned long long)x : (unsigned long long)x;
  const uint32_t r = (uint32_t)(mag % p);
  return (x < 0 && r) ? p - r : r;
}

// Forward transform of `npoly` consecutive polynomials of 2^log_n residues
// in shared memory, in place.  Every thread of the block calls it; it
// returns synchronised.
__device__ inline void forward(uint32_t* a, int npoly, int log_n,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ tw_sh,
                               uint32_t p) {
  const int half = 1 << (log_n - 1);
  const int total = npoly * half;
  int m = 1;
  for (int log_t = log_n - 1; log_t >= 0; --log_t, m <<= 1) {
    const int t = 1 << log_t;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int kk = k & (half - 1);
      const int i = kk >> log_t;
      const int j = ((k >> (log_n - 1)) << log_n) + (i << (log_t + 1)) +
                    (kk & (t - 1));
      uint32_t u = a[j], v = a[j + t];
      ct_butterfly(u, v, __ldg(tw + m + i), __ldg(tw_sh + m + i), p);
      a[j] = u;
      a[j + t] = v;
    }
    __syncthreads();
  }
}

// Inverse transform (bit-reversed in, natural out, times 1/N), in place;
// same calling rules as forward.
__device__ inline void inverse(uint32_t* a, int npoly, int log_n,
                               const uint32_t* __restrict__ tw,
                               const uint32_t* __restrict__ tw_sh,
                               uint32_t p, uint32_t n_inv,
                               uint32_t n_inv_sh) {
  const int half = 1 << (log_n - 1);
  const int total = npoly * half;
  for (int log_t = 0; log_t < log_n; ++log_t) {
    const int t = 1 << log_t;
    const int h = half >> log_t;
    for (int k = threadIdx.x; k < total; k += blockDim.x) {
      const int kk = k & (half - 1);
      const int i = kk >> log_t;
      const int j = ((k >> (log_n - 1)) << log_n) + (i << (log_t + 1)) +
                    (kk & (t - 1));
      uint32_t u = a[j], v = a[j + t];
      gs_butterfly(u, v, __ldg(tw + h + i), __ldg(tw_sh + h + i), p);
      a[j] = u;
      a[j + t] = v;
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < npoly << log_n; k += blockDim.x)
    a[k] = shoup_mul(a[k], n_inv, n_inv_sh, p);
  __syncthreads();
}

// Tables as ops/ntt.py lays them out: tw (P, 4, N) u32 rows = forward
// twiddles, their Shoup companions, inverse twiddles, theirs; consts (P, 3)
// u32 = p, N^-1 mod p, its companion.
struct Prime {
  const uint32_t* fwd;
  const uint32_t* fwd_sh;
  const uint32_t* inv;
  const uint32_t* inv_sh;
  uint32_t p, n_inv, n_inv_sh;
};

__device__ __forceinline__ Prime prime_of(const uint32_t* tw,
                                          const uint32_t* consts, int pr,
                                          int log_n) {
  const size_t n = (size_t)1 << log_n;
  const uint32_t* base = tw + (size_t)pr * 4 * n;
  return Prime{base, base + n, base + 2 * n, base + 3 * n,
               consts[3 * pr], consts[3 * pr + 1], consts[3 * pr + 2]};
}

// Threads per block for one or a few transforms of size N: every thread
// has at least one butterfly per stage.
inline int threads_for(int log_n) {
  const int half = 1 << (log_n - 1);
  return half < 512 ? half : 512;
}

}  // namespace ntt
