// banded_matmul, table form: the negacyclic banded int8 product of the
// external product, as int32 limb-product planes, for more than 8 lhs rows
// (banded_mm_latency.cu takes 8 or fewer).
//
// Replaces the TPU kernel concrete_tpu/ops/pallas_banded_mm.py
// banded_matmul_fused (:88, pallas_call :117), a drop-in for the JAX
// package's negacyclic_banded_matmul_planes:
//
//   out[b, co, a + s, t] = sum_{ci, j} lhs[a, b, ci*N + j]
//                                      * vv[ci, co, s, N-1 + t - j]
//
// lhs (A, B, Cin*N) int8, vv (Cin, Cout, S, 2N-1) int8 (the negacyclic
// extension [-w[1:], w] of each limb plane), out (B, Cout, S+A-1, N) int32.
// The lhs may also be kernel A's digit planes (l*A, B*(k+1), N), read in
// place with Cin = lev*(k+1) + r: row (lev, r) of lhs row b is plane
// lev*A + a, row b*(k+1) + r.  With l = 1 and k+1 = Cin that is the layout
// above: csrc/banded_wgmma.cuh addresses both so.
//
// Bound: operations.  B * Cout * (A*S pairs) * Cin * N^2 int8 MACs: 6.87e10
// at the 128-bit N=1024 table step (B=1024, Cin=8, Cout=2, S=4, A=1), about
// 0.069 ms at the 1,979 TOP/s int8 tensor-core peak (a MAC is 2
// operations), against 42 MB moved.  The TPU kernel filled an 8 MB Toeplitz
// rhs per J-block in VMEM, which does not fit the 227 KB of shared memory.
// Design: kernel B's wgmma main loop (csrc/banded_wgmma.cuh: the key band
// as register operand A, funnel-shifted from key-window words that serve
// all 64 t of a tile and all 128 rows; the lhs rows as the K-major
// swizzled shared-memory operand B, staged in 16-byte cp.async pieces into
// a 4-slot ring paced by full and empty mbarriers; one warpgroup and one
// int32 accumulator per output plane p), with an epilogue that stores each
// warpgroup's accumulator to out[b, co, p, t]: per register, 8 lanes
// write 32 consecutive bytes of one row.  Sums are int32 and never near
// 2^31 (Cin*N*A*127*128 = 1.3e8 here), so no .satfinite is asked for.

#include "banded_wgmma.cuh"

namespace {

using namespace banded;

// out[b, cout, p, t] = d_p[b, t] for the S+A-1 planes p.
struct PlaneStoreEpilogue {
  int* out;
  int n_out;

  __device__ __forceinline__ bool live(int p) const { return p < n_out; }
  static size_t smem(int) { return 0; }

  __device__ __forceinline__ void operator()(const Shape& sh, unsigned char*,
                                             int (&d)[64], bool live_wg,
                                             int t0, int b0, int cout,
                                             int p_lo) const {
    if (!live_wg) return;                         // per warpgroup
    const int tid = threadIdx.x, lane = tid & 31;
    const int wi = (tid >> 5) & 3, g = lane >> 2, tg = lane & 3;
    const int p = p_lo + (tid >> 7);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int b = b0 + frag_b(i, tg);
      if (b < sh.batch)
        out[((size_t)(b * sh.cout_n + cout) * n_out + p) * sh.n + t0 +
            frag_t(i, wi, g)] = d[i];
    }
  }
};

}  // namespace

extern "C" int banded_matmul(const void* lhs, const void* vv, void* out,
                             int a_limbs, int rows, int cin, int kp1,
                             int cout, int s_planes, int n, void* stream) {
  const int n_out = s_planes + a_limbs - 1;
  const long long vv_bytes = (long long)cin * cout * s_planes * (2LL * n - 1);
  Shape sh{(const int8_t*)lhs, (const int8_t*)vv,
           (const int8_t*)vv + vv_bytes, rows, a_limbs, kp1, n, s_planes,
           cin, 0, 0, 0, cout};
  return launch_banded_wgmma(sh, PlaneStoreEpilogue{(int*)out, n_out}, n_out,
                             (cudaStream_t)stream);
}
