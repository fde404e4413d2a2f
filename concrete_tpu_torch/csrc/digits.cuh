// Kernel 1's digit arithmetic as device functions: the rotated difference
// X^a acc - acc of one accumulator row at one coefficient, and its
// balanced gadget digits, rounded half up as refimpl.decompose.  Three
// kernels include it with the same arithmetic: csrc/rotate_decompose.cu
// (kernel 1, the digits mode: every level of every row, into global
// memory), csrc/blind_rotate_fused_latency.cu and
// csrc/blind_rotate_crt_scan.cu (one level's digits at the coefficients a
// thread's first transform pass reads, from the accumulator row in shared
// memory; the second in 32 bits in the acc32 mode, digit_top below).

#pragma once

#include <cstdint>

namespace digits {

// X^a row - row at coefficient t (mod 2^64), with a in [0, 2N): the
// source coefficient (t - a) mod 2N, negated past N.  T = uint64_t reads
// a u64 row; T = uint32_t the acc32 mode's top words, whose u64 value is
// hi * 2^32 (its negation stays exact in the top word, and the digits
// read only the top word whenever levels * base_log <= 31).
template <typename T>
__device__ __forceinline__ uint64_t rotate_diff(const T* row, int t, int a,
                                                int n) {
  const int top = sizeof(T) == 4 ? 32 : 0;
  int s = t - a;
  if (s < 0) s += 2 * n;
  const uint64_t x = (uint64_t)(s >= n ? row[s - n] : row[s]) << top;
  const uint64_t y = (uint64_t)row[t] << top;
  return (s >= n ? (uint64_t)0 - x : x) - y;
}

// round(v / 2^64): the rounded prefix that level 0's digit starts from.
__device__ __forceinline__ uint64_t first_prefix(uint64_t v) {
  return ((v >> 63) + 1) >> 1;
}

// Level lev's digit of v from w_prev, the rounded prefix of level lev - 1
// (first_prefix(v) at level 0), which it advances to level lev's.  The
// digit is tiny: its low 32 bits carry the signed value.
__device__ __forceinline__ int32_t next_digit(uint64_t v, uint64_t& w_prev,
                                              int lev, int base_log) {
  const uint64_t w = ((v >> (63 - (lev + 1) * base_log)) + 1) >> 1;
  const int32_t d = (int32_t)(uint32_t)(w - (w_prev << base_log));
  w_prev = w;
  return d;
}

// Level lev's digit of v alone, from the rounded prefixes of levels
// lev - 1 and lev.
__device__ __forceinline__ int32_t digit(uint64_t v, int lev, int base_log) {
  uint64_t w_prev = ((v >> (63 - lev * base_log)) + 1) >> 1;
  return next_digit(v, w_prev, lev, base_log);
}

// The acc32 mode's digits in 32-bit arithmetic, the same bits as digit()
// of v = h 2^32 wherever (lev + 1) base_log <= 31: h is the top word of
// X^a row - row (rotate_diff_top), and for m <= 31, v >> (63 - m) is
// h >> (31 - m), a value u of m + 1 bits whose rounding (u + 1) >> 1 is
// (u >> 1) + (u & 1), which stays within 32 bits.
__device__ __forceinline__ uint32_t rotate_diff_top(const uint32_t* row,
                                                    int t, int a, int n) {
  int s = t - a;
  if (s < 0) s += 2 * n;
  const uint32_t x = s >= n ? 0u - row[s - n] : row[s];
  return x - row[t];
}

__device__ __forceinline__ int32_t digit_top(uint32_t h, int lev,
                                             int base_log) {
  const uint32_t u0 = h >> (31 - lev * base_log);
  const uint32_t u1 = h >> (31 - (lev + 1) * base_log);
  const uint32_t w0 = (u0 >> 1) + (u0 & 1), w1 = (u1 >> 1) + (u1 & 1);
  return (int32_t)(w1 - (w0 << base_log));
}

}  // namespace digits
