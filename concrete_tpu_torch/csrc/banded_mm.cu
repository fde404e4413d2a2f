// banded_matmul: the negacyclic banded int8 product of the external product,
// as int32 limb-product planes.
//
// Replaces the TPU kernel concrete_tpu/ops/pallas_banded_mm.py
// banded_matmul_fused (:88, pallas_call :117), a drop-in for the JAX
// package's negacyclic_banded_matmul_planes:
//
//   out[b, co, a + s, t] = sum_{ci, j} lhs[a, b, ci*N + j]
//                                      * vv[ci, co, s, N-1 + t - j]
//
// lhs (A, B, Cin*N) int8, vv (Cin, Cout, S, 2N-1) int8 (the negacyclic
// extension [-w[1:], w] of each limb plane), out (B, Cout, S+A-1, N) int32,
// sums wrapping mod 2^32 as the MXU's preferred_element_type=int32 does.
// The lhs may also be kernel A's digit planes (l*A, B*(k+1), N), read in
// place with Cin = lev*(k+1) + r: row (lev, r) of lhs row b is plane
// lev*A + a, row b*(k+1) + r.  With l = 1 and k+1 = Cin that is the layout
// above, so the kernel takes kp1 = Cin / l and always indexes this way.
//
// Bound: operations.  B * Cout * (A*S pairs) * Cin * N^2 int8 MACs: 6.87e10
// at the 128-bit N=1024 table step (B=1024, Cin=8, Cout=2, S=4, A=1), about
// 0.069 ms at the 1,979 TOP/s int8 tensor-core peak (a MAC is 2
// operations), against 42 MB moved.  The TPU kernel filled an 8 MB Toeplitz
// rhs per J-block in VMEM, which does not fit the 227 KB of shared memory.
// Design:
//  - the tensor cores: mma.sync m16n8k32 on s8 tiles, s32 accumulators,
//    no .satfinite (plane sums stay far below 2^31: Cin*N*A*127*128 is
//    1.3e8 here);
//  - a block owns 64 lhs rows x 128 output coefficients of one (co, plane
//    p) and loops over the K dimension (a with 0 <= p - a < S, then ci,
//    then j), which the TPU's sequential grid carried; it writes its tile
//    once, so nothing is added across blocks;
//  - no band tile is built: for one (a, ci) the block stages the window of
//    vv its 128 outputs read, reversed (N + 127 bytes), and each B fragment
//    register (4 consecutive j at one output t) is a funnel shift of two
//    aligned words of it;
//  - the lhs is staged 64 rows x 128 j at a time with 16-byte loads, in
//    rows padded to 144 bytes so the A fragments' loads hit 32 banks; each
//    thread's two 16-byte pieces have their offsets computed once, which
//    keeps the kernel at 64 registers, 4 blocks per SM (recomputing them
//    per chunk took 95 registers, 2 blocks, and 21% more time on the H100);
//  - 8 warps, each 32 rows x 32 coefficients (2 x 4 MMA tiles); rows past
//    B are staged as zeros and not stored (the latency path has 2 rows).
// Not yet: wgmma, a cp.async/TMA pipeline, reuse of the window words
// across the four n tiles (ROADMAP).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;           // lhs rows per block
constexpr int BN = 128;          // output coefficients per block
constexpr int JC = 128;          // j per staged lhs chunk
constexpr int ASTR = JC + 16;    // padded row stride of the staged chunk
constexpr int WARPS_N = 4;       // warps along t; 2 along the rows
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS) banded_matmul_kernel(
    const int8_t* __restrict__ lhs, const int8_t* __restrict__ vv,
    int* __restrict__ out, int a_limbs, int rows, int cin, int kp1, int cout,
    int s_planes, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* as = smem;                 // [BM][ASTR]
  unsigned char* rv = smem + BM * ASTR;     // [n + BN + 16]
  const uint32_t* rv32 = reinterpret_cast<const uint32_t*>(rv);
  const int rvlen = n + BN + 16;
  const int n_out = s_planes + a_limbs - 1;
  const int t0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * BM;
  const int co = blockIdx.z / n_out, p = blockIdx.z % n_out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;
  const size_t row_len = (size_t)kp1 * n;         // one lhs row of a plane
  const size_t plane = (size_t)rows * row_len;     // one (lev, a) plane
  const size_t vlen = 2 * (size_t)n - 1;

  // this thread's staging slots: a 16-byte piece of one lhs row; offsets
  // within a plane, which the wrapper keeps under 2^32 bytes
  constexpr int SLOTS = BM * (JC / 16) / THREADS;
  unsigned s_src[SLOTS], s_dst[SLOTS];
  bool s_ok[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int i = tid + k * THREADS, r = i / (JC / 16), q = i % (JC / 16);
    s_ok[k] = b0 + r < rows;
    s_src[k] = (unsigned)((b0 + r) * row_len + 16 * q);
    s_dst[k] = r * ASTR + 16 * q;
  }

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  for (int a = 0; a < a_limbs; ++a) {
    const int s = p - a;
    if (s < 0 || s >= s_planes) continue;       // uniform over the block
    for (int ci = 0; ci < cin; ++ci) {
      const int8_t* lrow = lhs + (size_t)((ci / kp1) * a_limbs + a) * plane
                           + (size_t)(ci % kp1) * n;
      const int8_t* vrow = vv + ((size_t)(ci * cout + co) * s_planes + s) * vlen;
      for (int jc = 0; jc < n; jc += JC) {
        __syncthreads();                         // the last chunk is used
        if (jc == 0) {
          // rv[y] = vv[.., N-1 + t0 + BN-1 - y]: output t meets input j at
          // y = BN-1 - (t - t0) + j, rising with j
          for (int y = tid; y < rvlen; y += THREADS)
            rv[y] = y < n + BN - 1
                ? (unsigned char)vrow[n - 1 + t0 + BN - 1 - y] : 0;
        }
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          uint4 val = make_uint4(0, 0, 0, 0);
          if (s_ok[k])
            val = *reinterpret_cast<const uint4*>(lrow + s_src[k] + jc);
          *reinterpret_cast<uint4*>(as + s_dst[k]) = val;
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < JC; ks += 32) {
          // A fragments (row-major 16 x 32): rows g and g+8, bytes 4tg..+3
          // and 16+4tg..+3 of the k slice
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const unsigned char* ap =
                as + (wm * 32 + mt * 16 + g) * ASTR + ks + 4 * tg;
            af[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
            af[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * ASTR);
            af[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
            af[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * ASTR + 16);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            // B fragment (col-major 32 x 8): column g is output t, rows
            // 4tg..+3 and 16+4tg..+3 are inputs j: bytes y..y+3 of rv
            const int y = BN - 1 - (wn * 32 + nt * 8 + g) + jc + ks + 4 * tg;
            const uint32_t* w = rv32 + (y >> 2);
            const int sh = 8 * (y & 3);
            const uint32_t b0f = __funnelshift_r(w[0], w[1], sh);
            const uint32_t b1f = __funnelshift_r(w[4], w[5], sh);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0f, b1f);
          }
        }
      }
    }
  }

  // C fragment: rows g and g+8, columns 2tg, 2tg+1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int b = b0 + wm * 32 + mt * 16 + g + 8 * half;
      if (b >= rows) continue;
      int* orow = out + ((size_t)(b * cout + co) * n_out + p) * n + t0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<int2*>(orow + wn * 32 + nt * 8 + 2 * tg) =
            make_int2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  }
}

}  // namespace

extern "C" int banded_matmul(const void* lhs, const void* vv, void* out,
                             int a_limbs, int rows, int cin, int kp1,
                             int cout, int s_planes, int n, void* stream) {
  // 9.4 KB + N: within the 48 KB any kernel may take without opting in
  const size_t smem = (size_t)BM * ASTR + (size_t)n + BN + 16;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / BN, (rows + BM - 1) / BM,
                  cout * (s_planes + a_limbs - 1));
  banded_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)lhs, (const int8_t*)vv, (int*)out, a_limbs, rows, cin,
      kp1, cout, s_planes, n);
  return (int)cudaGetLastError();
}
