// Kernel A of the banded blind-rotate step: rotate, subtract, decompose,
// split into int8 limbs.  (Its digits-only mode, kernel 1 of the CRT-NTT
// path, is rotate_decompose_digits below.)
//
// Replaces the TPU kernels concrete_tpu/ops/pallas_step.py
// rotate_decompose_limbs (:173) and rotate_decompose_limbs_hi (:275).
// Those keep the u64 accumulator as (lo, hi) u32 planes and rotate it with
// a log-shear of masked rolls, because the TPU has no 64-bit datapath and
// slow gathers; the hi variant reads only the top word when the low word is
// provably zero.  Here the accumulator is one native u64 array and the
// negacyclic rotation is a gather, so a single kernel serves both (it is
// bit-identical to the hi variant wherever that one applies).
//
// For each accumulator row r (one GLWE component of one ciphertext) with
// rotation a = a_rows[r] in [0, 2N) and each coefficient t:
//   rot[t]  = X^a * acc[r] at t: src = (t - a) mod 2N, negated past N
//   diff    = rot[t] - acc[r][t]                       (mod 2^64)
//   digits  = balanced gadget decomposition of diff (base_log, levels),
//             round half up, as refimpl.decompose
//   limbs   = each digit split into a_limbs balanced int8 limbs
// out[lev * a_limbs + limb][r][t] = limb `limb` of digit `lev`.
//
// Bound: bytes.  Per element it reads 8 bytes of the accumulator (the
// gathered source is the same array, so L2 serves it) and writes
// levels * a_limbs bytes, with a few dozen integer operations.  At the
// 128-bit N=1024 shape (2048 rows) that is 16.8 MB in and 8.4 MB out, about
// 7.5 us at 3.35 TB/s.  Design: one thread per 4 consecutive coefficients,
// so neighbouring threads read neighbouring 32-byte runs of the accumulator
// and each output plane is written as one aligned 32-bit word per thread;
// a grid-stride loop covers any batch.

#include <cstdint>
#include <cuda_runtime.h>

#include "digits.cuh"

namespace {

__global__ void rotate_decompose_kernel(
    const uint64_t* __restrict__ acc, const int32_t* __restrict__ a_rows,
    int8_t* __restrict__ out, int rows, int n, int base_log, int levels,
    int a_limbs) {
  const int quads_per_row = n / 4;
  const long long quads = (long long)rows * quads_per_row;
  const long long two_n = 2LL * n;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < quads; q += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(q / quads_per_row);
    const int t0 = (int)(q % quads_per_row) * 4;
    const uint64_t* src = acc + (size_t)row * n;
    // any int rotation is reduced mod 2N, so no read leaves the row
    const long long a = ((long long)a_rows[row] % two_n + two_n) % two_n;
    uint64_t v[4], w_prev[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + k;
      const long long s = (t - a + two_n) % two_n;
      const uint64_t x = s >= n ? (uint64_t)0 - src[s - n] : src[s];
      v[k] = x - src[t];
      w_prev[k] = ((v[k] >> 63) + 1) >> 1;   // w_0: round(v / 2^64)
    }
    for (int lev = 0; lev < levels; ++lev) {
      const int shift = 63 - (lev + 1) * base_log;
      int64_t rem[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t w = ((v[k] >> shift) + 1) >> 1;
        // the digit is tiny: its low 32 bits carry the signed value
        rem[k] = (int32_t)(uint32_t)(w - (w_prev[k] << base_log));
        w_prev[k] = w;
      }
      for (int limb = 0; limb < a_limbs; ++limb) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          int byte;
          if (limb < a_limbs - 1) {
            byte = (int)(rem[k] & 0xFF);
            const int carry = byte >= 128;
            byte -= carry << 8;
            rem[k] = (rem[k] >> 8) + carry;
          } else {
            byte = (int)rem[k];   // the top limb takes the remainder
          }
          word |= (uint32_t)(uint8_t)(int8_t)byte << (8 * k);
        }
        int8_t* plane = out + (size_t)(lev * a_limbs + limb) * rows * n;
        *reinterpret_cast<uint32_t*>(plane + (size_t)row * n + t0) = word;
      }
    }
  }
}

// Kernel 1 of the CRT-NTT path, the digits-only mode of kernel A:
// rotate, subtract, decompose, and write the signed gadget digits as int32
// planes out[lev][r][t], no limb split.  Replaces the TPU kernel
// concrete_tpu/ops/pallas_step.py rotate_decompose_digits (:322) and the
// rotate_diff_digits(_hi) front of blind_rotate_fused (:210, :234).
// T = uint64_t reads the u64 accumulator; T = uint32_t reads the acc32
// mode's top words.  The arithmetic is csrc/digits.cuh's, which the B <= 4
// CRT-NTT blind rotate (csrc/blind_rotate_fused_latency.cu) shares.
// Bound: bytes (8 or 4 read, 4 * levels written per coefficient); same
// thread layout as kernel A, each thread storing 16 aligned bytes per
// level.
template <typename T>
__global__ void rotate_decompose_digits_kernel(
    const T* __restrict__ acc, const int32_t* __restrict__ a_rows,
    int32_t* __restrict__ out, int rows, int n, int base_log, int levels) {
  const int quads_per_row = n / 4;
  const long long quads = (long long)rows * quads_per_row;
  const long long two_n = 2LL * n;
  for (long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       q < quads; q += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(q / quads_per_row);
    const int t0 = (int)(q % quads_per_row) * 4;
    const T* src = acc + (size_t)row * n;
    const int a = (int)(((long long)a_rows[row] % two_n + two_n) % two_n);
    uint64_t v[4], w_prev[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = digits::rotate_diff(src, t0 + k, a, n);
      w_prev[k] = digits::first_prefix(v[k]);
    }
    for (int lev = 0; lev < levels; ++lev) {
      int4 d;
      int* dk = &d.x;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dk[k] = digits::next_digit(v[k], w_prev[k], lev, base_log);
      *reinterpret_cast<int4*>(out + ((size_t)lev * rows + row) * n + t0) =
          d;
    }
  }
}

}  // namespace

extern "C" int rotate_decompose_digits(const void* acc, int acc32,
                                       const void* a_rows, void* out,
                                       int rows, int n, int base_log,
                                       int levels, void* stream) {
  const int threads = 256;
  const long long quads = (long long)rows * (n / 4);
  long long blocks = (quads + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  if (acc32)
    rotate_decompose_digits_kernel<uint32_t><<<(unsigned)blocks, threads, 0,
                                               (cudaStream_t)stream>>>(
        (const uint32_t*)acc, (const int32_t*)a_rows, (int32_t*)out, rows,
        n, base_log, levels);
  else
    rotate_decompose_digits_kernel<uint64_t><<<(unsigned)blocks, threads, 0,
                                               (cudaStream_t)stream>>>(
        (const uint64_t*)acc, (const int32_t*)a_rows, (int32_t*)out, rows,
        n, base_log, levels);
  return (int)cudaGetLastError();
}

extern "C" int rotate_decompose(const void* acc, const void* a_rows,
                                void* out, int rows, int n, int base_log,
                                int levels, int a_limbs, void* stream) {
  const int threads = 256;
  const long long quads = (long long)rows * (n / 4);
  long long blocks = (quads + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  rotate_decompose_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint64_t*)acc, (const int32_t*)a_rows, (int8_t*)out, rows, n,
      base_log, levels, a_limbs);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
