// Kernel 3 of the CRT-NTT path: one blind-rotate step's external product
// of the gadget digits with the bootstrap key, per CRT prime, exactly.
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
// For ciphertext b and prime p (one CTA each), with Cin = levels * (k+1):
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
// per coefficient are far fewer bytes.  Design: the k+1 output spectra
// and one working polynomial live in shared memory ((k+2) N 4 bytes:
// 48 KB at N=4096, 192 KB at N=16384 for k=1); each digit polynomial is
// loaded, transformed and multiplied into the k+1 accumulators in place,
// then the k+1 inverse transforms run together, halving their barriers.

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

__global__ void crt_external_product_kernel(
    const int32_t* __restrict__ digits, const uint32_t* __restrict__ spec,
    const uint32_t* __restrict__ spec_sh, uint32_t* __restrict__ out,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ consts,
    int batch, int levels, int kp1, int log_n) {
  extern __shared__ uint32_t smem[];
  const int n = 1 << log_n;
  uint32_t* acc = smem;               // [kp1][n]
  uint32_t* work = smem + kp1 * n;    // [n]
  const int b = blockIdx.x, pr = blockIdx.y;
  const int rows = batch * kp1, cin = levels * kp1;
  const ntt::Prime q = ntt::prime_of(tw, consts, pr, log_n);
  const uint32_t p = q.p;

  for (int i = threadIdx.x; i < kp1 * n; i += blockDim.x) acc[i] = 0;
  for (int ci = 0; ci < cin; ++ci) {
    const int lev = ci / kp1, comp = ci % kp1;
    const int32_t* src = digits + ((size_t)lev * rows + b * kp1 + comp) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int32_t d = src[i];          // |d| <= 2^(base_log-1) < p
      work[i] = d < 0 ? (uint32_t)(d + (int32_t)p) : (uint32_t)d;
    }
    __syncthreads();
    ntt::forward(work, 1, log_n, q.fwd, q.fwd_sh, p);
    const size_t key = ((size_t)(pr * cin + ci) * kp1) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t x = work[i];
      for (int co = 0; co < kp1; ++co) {
        const size_t kidx = key + (size_t)co * n + i;
        acc[co * n + i] = ntt::mul_add(acc[co * n + i], x, __ldg(spec + kidx),
                                       __ldg(spec_sh + kidx), p);
      }
    }
    __syncthreads();
  }
  ntt::inverse(acc, kp1, log_n, q.inv, q.inv_sh, p, q.n_inv, q.n_inv_sh);
  uint32_t* dst = out + ((size_t)pr * rows + (size_t)b * kp1) * n;
  for (int i = threadIdx.x; i < kp1 * n; i += blockDim.x) dst[i] = acc[i];
}

}  // namespace

extern "C" int crt_external_product(const void* digits, const void* spec,
                                    const void* spec_sh, void* out,
                                    const void* tw, const void* consts,
                                    int batch, int levels, int kp1,
                                    int n_primes, int log_n, void* stream) {
  const int smem = (int)(sizeof(uint32_t) * (size_t)(kp1 + 1) << log_n);
  cudaError_t err = cudaFuncSetAttribute(
      crt_external_product_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)batch, (unsigned)n_primes);
  crt_external_product_kernel<<<grid, ntt::threads_for(log_n), smem,
                                (cudaStream_t)stream>>>(
      (const int32_t*)digits, (const uint32_t*)spec,
      (const uint32_t*)spec_sh, (uint32_t*)out, (const uint32_t*)tw,
      (const uint32_t*)consts, batch, levels, kp1, log_n);
  return (int)cudaGetLastError();
}
