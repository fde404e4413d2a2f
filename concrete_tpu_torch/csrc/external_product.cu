// Kernel B of the banded blind-rotate step: the external product of the
// decomposed accumulator with one bootstrap-key step, shift-added into the
// u64 accumulator in place.
//
// Replaces the TPU kernels concrete_tpu/ops/pallas_dot_recombine.py
// dot_recombine (:288) and dot_recombine_hi (:203); its epilogue does the
// shift-add of concrete_tpu/ops/pallas_step.py recombine_accumulate (:385),
// which csrc/recombine_accumulate.cu ports on its own.  On the TPU
// the product is one MXU matmul against a Toeplitz rhs materialised from
// the BSK step (64 MB per step at N=1024, build_fused_rhs), followed by an
// epilogue on (lo, hi) u32 pairs.  Here the Toeplitz structure is read
// straight from the packed BSK: row t of the band is the window
// vv[N-1+t-j] of the negacyclically extended key polynomial.
//
//   acc[b, cout, t] += sum_p 2^(8(p + limb_offset)) *
//        sum_{cin, a, j; s = p - a in [0, S)}
//            d[b, cin, a, j] * vv[cin, cout, s, N-1+t-j]        (mod 2^64)
//
// d[b, cin, a, j] = planes[lev * A + a][b * (k+1) + r][j], cin = lev(k+1)+r
// (kernel A's output, unchanged); vv is one step of the pack_bsk layout
// (Cin, Cout, S, 2N-1); p runs over the kept planes [0, keep).
//
// Bound: operations.  B * Cin * A * Cout * keep * N^2 int8 MACs per launch,
// 6.9e10 at the 128-bit N=1024 shape (B=1024, Cin=8, Cout=2, keep=4), about
// 69 us at the 1,979 TOP/s int8 tensor-core peak (a MAC is 2 operations),
// against 8 MB of digits, 131 KB of key and 16.8 MB of accumulator each way.
// Only the tensor cores reach that rate, and on Hopper only through wgmma.
// The main loop is csrc/banded_wgmma.cuh's, shared with kernel 9's table
// form (its comments give the roles: the key band as the register operand
// A, the digits as swizzled shared-memory tiles in a 4-slot cp.async ring
// paced by full and empty mbarriers, one warpgroup per kept plane p; more
// planes than a block holds take more blocks, whose sums meet in acc
// through 64-bit atomics, exact mod 2^64 in any order).  The planes' int32
// sums overflow int32 once shifted, so each keeps its own accumulator.
// This file adds the epilogue: the planes' sums meet in shared memory, and
// one pass shifts, adds and accumulates them into acc, 64 consecutive t per
// ciphertext.
// What is left above the bound (tools/ablate_kernels.py, PERF.md): the
// digit staging, 16 t-blocks x 2 outputs re-read every digit, 256 MB of L2
// traffic per launch at the table step (about a third of the time); the
// fragment build; each chunk's wgmma.wait_group 0 and the grid's two
// waves.  The tool times those parts through the header's ABLATE_*
// switches, which only its builds set.

#include "banded_wgmma.cuh"

namespace {

using namespace banded;

constexpr int RED = TM + 4;       // padded row of the epilogue's staging

// acc[b, cout, t] += sum_p d_p[b, t] << 8 (p + limb_offset), mod 2^64.
struct ShiftAddEpilogue {
  unsigned long long* acc;
  int keep, limb_offset;

  __device__ __forceinline__ bool live(int p) const {
    return p < keep && 8 * (p + limb_offset) < 64;
  }
  static size_t smem(int n_wg) { return (size_t)n_wg * BN * RED * sizeof(int); }

  __device__ __forceinline__ void operator()(const Shape& sh,
                                             unsigned char* smem,
                                             int (&d)[64], bool live_wg,
                                             int t0, int b0, int cout,
                                             int p_lo) const {
    // every plane's int32 sums into shared memory, then one pass adds the
    // shifted planes into acc (64 consecutive t per ciphertext); planes of
    // other blocks meet there through atomics
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
    const int wi = (tid >> 5) & 3, g = lane >> 2, tg = lane & 3;
    const bool atomic_out = (int)gridDim.z > sh.cout_n;
    __syncthreads();
    int* red = reinterpret_cast<int*>(smem);            // [n_wg][BN][RED]
#pragma unroll
    for (int i = 0; i < 64; ++i)
      red[(wg * BN + frag_b(i, tg)) * RED + frag_t(i, wi, g)] =
          live_wg ? d[i] : 0;
    __syncthreads();
    for (int i = tid; i < BN * TM; i += blockDim.x) {
      const int bl = i / TM, tl = i % TM, b = b0 + bl;
      if (b >= sh.batch) break;                  // i only grows past here
      unsigned long long add = 0;
      for (int w = 0; w < sh.n_wg; ++w) {
        const int pw = p_lo + w;
        if (live(pw))
          add += (unsigned long long)(long long)red[(w * BN + bl) * RED + tl]
                 << (8 * (pw + limb_offset));
      }
      unsigned long long* dst =
          acc + ((size_t)b * sh.kp1 + cout) * sh.n + t0 + tl;
      if (atomic_out)
        atomicAdd(dst, add);
      else
        *dst += add;
    }
  }
};

}  // namespace

extern "C" int external_product_accumulate(
    const void* planes, const void* vv, void* acc, int batch, int levels,
    int a_limbs, int kp1, int n, int s_planes, int keep, int limb_offset,
    void* stream) {
  // planes at shifts >= 64 add nothing mod 2^64
  const int planes_used = keep < 8 - limb_offset ? keep : 8 - limb_offset;
  const int cin_n = levels * kp1;
  const long long vv_bytes =
      (long long)cin_n * kp1 * s_planes * (2LL * n - 1);
  Shape sh{(const int8_t*)planes, (const int8_t*)vv,
           (const int8_t*)vv + vv_bytes, batch, a_limbs, kp1, n, s_planes,
           cin_n, 0, 0, 0, kp1};
  return launch_banded_wgmma(
      sh, ShiftAddEpilogue{(unsigned long long*)acc, keep, limb_offset},
      planes_used, (cudaStream_t)stream);
}
