// Instruction-count probes for the operation bounds of the NTT kernels.
//
// Never launched.  Each probe is a straight chain of R dependent copies of
// one operation of csrc/ntt.cuh (the Cooley-Tukey and Gentleman-Sande
// butterflies, the pointwise multiply-add, the Shoup multiply), built into
// the kernels' library with the same flags.  chip_smoke.py reads the SASS
// of the library (cuobjdump -sass), sorts each probe's instructions by the
// pipe that executes them, and takes (count at R=64 - count at R=32) / 32
// as the instructions of one operation: the loads, stores and set-up
// common to both lengths cancel.

#include <cstdint>

#include "ntt.cuh"

namespace {

// d: u, v, p; w: R (twiddle, companion) pairs
template <int R>
__device__ __forceinline__ void ct_chain(uint32_t* d, const uint32_t* w) {
  const uint32_t p = d[2];
  uint32_t u = d[0], v = d[1];
#pragma unroll
  for (int r = 0; r < R; ++r)
    ntt::ct_butterfly(u, v, __ldg(w + 2 * r), __ldg(w + 2 * r + 1), p);
  d[0] = u;
  d[1] = v;
}

template <int R>
__device__ __forceinline__ void gs_chain(uint32_t* d, const uint32_t* w) {
  const uint32_t p = d[2];
  uint32_t u = d[0], v = d[1];
#pragma unroll
  for (int r = 0; r < R; ++r)
    ntt::gs_butterfly(u, v, __ldg(w + 2 * r), __ldg(w + 2 * r + 1), p);
  d[0] = u;
  d[1] = v;
}

// d: acc, x, p; w: R (key, companion) pairs
template <int R>
__device__ __forceinline__ void mul_add_chain(uint32_t* d, const uint32_t* w) {
  const uint32_t p = d[2], x = d[1];
  uint32_t acc = d[0];
#pragma unroll
  for (int r = 0; r < R; ++r)
    acc = ntt::mul_add(acc, x, __ldg(w + 2 * r), __ldg(w + 2 * r + 1), p);
  d[0] = acc;
}

template <int R>
__device__ __forceinline__ void shoup_chain(uint32_t* d, const uint32_t* w) {
  const uint32_t p = d[2];
  uint32_t a = d[0];
#pragma unroll
  for (int r = 0; r < R; ++r)
    a = ntt::shoup_mul(a, __ldg(w + 2 * r), __ldg(w + 2 * r + 1), p);
  d[0] = a;
}

}  // namespace

#define PROBE(NAME, CHAIN)                                                 \
  extern "C" __global__ void probe_##NAME##_32(uint32_t* d,                \
                                               const uint32_t* w) {        \
    CHAIN<32>(d, w);                                                       \
  }                                                                        \
  extern "C" __global__ void probe_##NAME##_64(uint32_t* d,                \
                                               const uint32_t* w) {        \
    CHAIN<64>(d, w);                                                       \
  }

PROBE(ct_butterfly, ct_chain)
PROBE(gs_butterfly, gs_chain)
PROBE(mul_add, mul_add_chain)
PROBE(shoup_mul, shoup_chain)
