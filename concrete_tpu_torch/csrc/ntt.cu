// Kernel 2 of the CRT-NTT path: standalone negacyclic NTT / inverse NTT,
// one CTA per (polynomial, prime), the whole polynomial in shared memory.
//
// Replaces the TPU kernels concrete_tpu/ops/pallas_ntt.py ntt_fwd_pallas
// (:374) and ntt_inv_pallas (:417).  Those run a four-step transform as
// int8 MXU matmuls with Montgomery combines, because the TPU's vector unit
// has no 32x32->64 multiply; Hopper has one (IMAD.HI), so this is a plain
// radix-2 transform with Shoup multiplies (csrc/ntt.cuh).  The output
// order is bit-reversed instead of four-step; tests map one to the other.
//
// The forward transform packs the bootstrap key (ops/fused_ntt.py
// pack_bsk_fused: every BSK polynomial, every prime, one launch) and reads
// signed 64-bit coefficients, reducing each once mod p.  The inverse takes
// spectra in the forward's order and returns canonical residues.
//
// Bound: operations.  (N/2) log2 N butterflies per transform, each one
// Shoup multiply (3 IMADs) plus two reduced add/subtracts; the bytes (8 in
// and 4 out per coefficient and prime) take far less time at the H100's
// rates.  Design: one CTA per transform keeps all log2 N stages in shared
// memory with one barrier per stage; up to 512 threads, so each thread has
// N/1024 butterflies per stage at N >= 1024; twiddles are read through the
// read-only cache (the first stages broadcast one value to every thread).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt.cuh"

namespace {

__global__ void ntt_forward_kernel(const long long* __restrict__ x,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ tw,
                                   const uint32_t* __restrict__ consts,
                                   int polys, int log_n) {
  extern __shared__ uint32_t a[];
  const int n = 1 << log_n;
  const int poly = blockIdx.x, pr = blockIdx.y;
  const ntt::Prime q = ntt::prime_of(tw, consts, pr, log_n);
  const long long* src = x + (size_t)poly * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    a[i] = ntt::residue_i64(src[i], q.p);
  __syncthreads();
  ntt::forward(a, 1, log_n, q.fwd, q.fwd_sh, q.p);
  uint32_t* dst = out + ((size_t)pr * polys + poly) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = a[i];
}

__global__ void ntt_inverse_kernel(const uint32_t* __restrict__ spec,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ tw,
                                   const uint32_t* __restrict__ consts,
                                   int polys, int log_n) {
  extern __shared__ uint32_t a[];
  const int n = 1 << log_n;
  const int poly = blockIdx.x, pr = blockIdx.y;
  const ntt::Prime q = ntt::prime_of(tw, consts, pr, log_n);
  const size_t off = ((size_t)pr * polys + poly) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = spec[off + i];
  __syncthreads();
  ntt::inverse(a, 1, log_n, q.inv, q.inv_sh, q.p, q.n_inv, q.n_inv_sh);
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[off + i] = a[i];
}

}  // namespace

extern "C" int ntt_forward(const void* x, void* out, const void* tw,
                           const void* consts, int polys, int n_primes,
                           int log_n, void* stream) {
  const int smem = (int)(sizeof(uint32_t) << log_n);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)polys, (unsigned)n_primes);
  ntt_forward_kernel<<<grid, ntt::threads_for(log_n), smem,
                       (cudaStream_t)stream>>>(
      (const long long*)x, (uint32_t*)out, (const uint32_t*)tw,
      (const uint32_t*)consts, polys, log_n);
  return (int)cudaGetLastError();
}

extern "C" int ntt_inverse(const void* spec, void* out, const void* tw,
                           const void* consts, int polys, int n_primes,
                           int log_n, void* stream) {
  const int smem = (int)(sizeof(uint32_t) << log_n);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)polys, (unsigned)n_primes);
  ntt_inverse_kernel<<<grid, ntt::threads_for(log_n), smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)spec, (uint32_t*)out, (const uint32_t*)tw,
      (const uint32_t*)consts, polys, log_n);
  return (int)cudaGetLastError();
}
