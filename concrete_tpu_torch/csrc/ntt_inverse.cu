// Kernel 2 of the CRT-NTT path, the inverse: (P, M, N) spectra in the
// forward's bit-reversed order (csrc/ntt.cu) -> (P, M, N) canonical
// coefficient residues, natural order, times 1/N.
//
// Replaces the TPU kernel concrete_tpu/ops/pallas_ntt.py ntt_inv_pallas
// (:417, pallas_call :425), a four-step inverse on the MXU; here it is the
// passes of csrc/ntt_regs.cuh run backward, kernel 3's inverse_store
// without its accumulators: one block per (polynomial, prime), each thread
// reading residues 16g..16g+15 of its groups by four 16-byte loads (where
// the forward's last pass left them), the Gentleman-Sande passes in
// registers with one barrier per exchange, and the 1/N Shoup scaling
// stored at the first pass's coalesced positions.
//
// Bound: operations, (N/2) log2 N butterflies and N scalings per
// polynomial and prime against 8 bytes per coefficient.  Compiled once per
// N: N >= 16 through the register schedule, N = 4 and 8 by one thread per
// transform (ntt_inverse_tiny).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_regs.cuh"

namespace {

// registers a thread is held to at N = 1024 .. 4096: four blocks of 256
// threads a SM at N = 4096, the fastest cap of those tools/ablate_kernels.py
// times (ABLATE_REGS)
#ifdef ABLATE_REGS
constexpr int INVERSE_REGS = ABLATE_REGS;
#else
constexpr int INVERSE_REGS = 64;
#endif

template <int LOG_N>
__global__ void __launch_bounds__(threads_of(LOG_N),
                                  min_blocks_of(LOG_N, INVERSE_REGS))
ntt_inverse_kernel(
    const uint32_t* __restrict__ spec, uint32_t* __restrict__ out,
    const uint2* __restrict__ tw, const uint32_t* __restrict__ consts,
    int polys) {
  extern __shared__ uint32_t buf[];            // [2][N], swizzled
  constexpr int n = 1 << LOG_N;
  constexpr int G = LOG_N == 14 ? 2 : 1, T = n / (E * G);
  const int m = blockIdx.x, pr = blockIdx.y, tid = threadIdx.x;
  const uint32_t* c = consts + 8 * pr;
  const size_t off = ((size_t)pr * polys + m) * n;
  uint32_t x[G][E];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const uint4* src =
        reinterpret_cast<const uint4*>(spec + off + E * (tid + i * T));
#pragma unroll
    for (int v = 0; v < E / 4; ++v) {
      const uint4 w = __ldg(src + v);
      x[i][4 * v] = w.x;
      x[i][4 * v + 1] = w.y;
      x[i][4 * v + 2] = w.z;
      x[i][4 * v + 3] = w.w;
    }
  }
  int ex = 0;
  inverse_store<G, LOG_N>(x, buf, ex, tw + ((size_t)pr * 2 + 1) * n,
                          __ldg(c), __ldg(c + 1), __ldg(c + 2), out + off);
}

// N = 4 or 8: one thread per (polynomial, prime), the butterflies of
// ops/ntt.py ntt_inverse_plain in its order.
template <int LOG_N>
__global__ void ntt_inverse_tiny(const uint32_t* __restrict__ spec,
                                 uint32_t* __restrict__ out,
                                 const uint2* __restrict__ tw,
                                 const uint32_t* __restrict__ consts,
                                 int polys) {
  constexpr int n = 1 << LOG_N;
  const int m = blockIdx.x * blockDim.x + threadIdx.x, pr = blockIdx.y;
  if (m >= polys) return;
  const uint32_t* c = consts + 8 * pr;
  const uint32_t p = __ldg(c);
  const uint2* inv = tw + ((size_t)pr * 2 + 1) * n;
  const size_t off = ((size_t)pr * polys + m) * n;
  uint32_t a[n];
#pragma unroll
  for (int j = 0; j < n; ++j) a[j] = spec[off + j];
#pragma unroll
  for (int h = n / 2, t = 1; h >= 1; h /= 2, t *= 2)
#pragma unroll
    for (int i = 0; i < h; ++i)
#pragma unroll
      for (int j = 2 * i * t; j < 2 * i * t + t; ++j) {
        const uint2 w = __ldg(inv + h + i);
        ntt::gs_butterfly(a[j], a[j + t], w.x, w.y, p);
      }
#pragma unroll
  for (int j = 0; j < n; ++j)
    out[off + j] = ntt::shoup_mul(a[j], __ldg(c + 1), __ldg(c + 2), p);
}

template <int LOG_N>
cudaError_t launch(const void* spec, void* out, const void* tw,
                   const void* consts, int polys, int n_primes,
                   void* stream) {
  constexpr int G = LOG_N == 14 ? 2 : 1;
  const int smem = (int)(2 * sizeof(uint32_t)) << LOG_N;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_inverse_kernel<LOG_N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)polys, (unsigned)n_primes);
  ntt_inverse_kernel<LOG_N>
      <<<grid, (1 << LOG_N) / (E * G), smem, (cudaStream_t)stream>>>(
          (const uint32_t*)spec, (uint32_t*)out, (const uint2*)tw,
          (const uint32_t*)consts, polys);
  return cudaGetLastError();
}

template <int LOG_N>
cudaError_t launch_tiny(const void* spec, void* out, const void* tw,
                        const void* consts, int polys, int n_primes,
                        void* stream) {
  const dim3 grid((unsigned)((polys + 127) / 128), (unsigned)n_primes);
  ntt_inverse_tiny<LOG_N><<<grid, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)spec, (uint32_t*)out, (const uint2*)tw,
      (const uint32_t*)consts, polys);
  return cudaGetLastError();
}

}  // namespace

// spec (P, M, N) u32 -> out (P, M, N) u32; tw and consts as ntt_forward's
// (csrc/ntt.cu).  N = 2^log_n, 4 <= N <= 16384.
extern "C" int ntt_inverse(const void* spec, void* out, const void* tw,
                           const void* consts, int polys, int n_primes,
                           int log_n, void* stream) {
#define NTT_INV_CASE(L)                                                    \
  case L:                                                                  \
    return (int)launch<L>(spec, out, tw, consts, polys, n_primes, stream);
  switch (log_n) {
    case 2: return (int)launch_tiny<2>(spec, out, tw, consts, polys,
                                       n_primes, stream);
    case 3: return (int)launch_tiny<3>(spec, out, tw, consts, polys,
                                       n_primes, stream);
    NTT_INV_CASE(4) NTT_INV_CASE(5) NTT_INV_CASE(6) NTT_INV_CASE(7)
    NTT_INV_CASE(8) NTT_INV_CASE(9) NTT_INV_CASE(10) NTT_INV_CASE(11)
    NTT_INV_CASE(12) NTT_INV_CASE(13) NTT_INV_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NTT_INV_CASE
}
