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
// against 8 MB of digits and 131 KB of key read.  This first version uses
// no tensor cores: it issues dp4a (4 int8 MACs per instruction).  Design:
//  - a block owns 4 ciphertexts x 128 output coefficients x one cout, and
//    one thread row per kept plane p, so no thread needs a dynamic plane
//    index: each thread sums 4 ciphertexts x 4 coefficients of its plane;
//  - per input row cin, the block stages its digit words and the reversed
//    key window it needs into shared memory; 4 consecutive j of one digit
//    row are one 32-bit word, and the matching 4 key bytes of output t are
//    a funnel shift of two aligned words of the reversed window, so each
//    key word serves 4 outputs and each funnel shift 4 ciphertexts;
//  - int32 plane sums cannot overflow (A*Cin*N*128*128 = 1.3e8 here);
//  - epilogue: the plane sums meet in shared memory and one pass shifts,
//    adds and accumulates them into the u64 accumulator, mod 2^64.
// wgmma on s8 tiles is the next step (ROADMAP).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int RB = 4;   // ciphertexts per thread (and per block)

__global__ void external_product_kernel(
    const int8_t* __restrict__ planes, const int8_t* __restrict__ vv,
    unsigned long long* __restrict__ acc, int batch, int levels,
    int a_limbs, int kp1, int n, int s_planes, int keep, int limb_offset,
    int tt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = n / 4;                 // digit words per row
  const int rvlen = n + tt;             // reversed key window, padded
  uint32_t* d_s = reinterpret_cast<uint32_t*>(smem);          // [RB][A][nw]
  unsigned char* rv = smem + RB * a_limbs * n;                  // [S][rvlen]
  int* red = reinterpret_cast<int*>(rv + s_planes * rvlen);    // [keep][RB][tt]

  const int tx = threadIdx.x, p = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = p * blockDim.x + tx;
  const int t0 = blockIdx.x * tt;
  const int b0 = blockIdx.y * RB;
  const int cout = blockIdx.z;
  const int rows = batch * kp1;
  const size_t vrow_len = 2 * (size_t)n - 1;

  int sum[RB][4];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[rb][q] = 0;

  for (int cin = 0; cin < levels * kp1; ++cin) {
    const int lev = cin / kp1, r = cin % kp1;
    __syncthreads();
    for (int i = tid; i < RB * a_limbs * nw; i += nthreads) {
      const int w = i % nw, ra = i / nw;
      const int a = ra % a_limbs, b = b0 + ra / a_limbs;
      uint32_t val = 0;
      if (b < batch) {
        const int8_t* row = planes +
            ((size_t)(lev * a_limbs + a) * rows + (size_t)b * kp1 + r) * n;
        val = reinterpret_cast<const uint32_t*>(row)[w];
      }
      d_s[i] = val;
    }
    // rv[s][y] = vv[cin, cout, s, N + t0 + tt - 2 - y]: output t, input j
    // meet at y = t0 + tt - 1 - t + j, increasing with j
    const int8_t* vbase = vv + (size_t)(cin * kp1 + cout) * s_planes * vrow_len;
    for (int i = tid; i < s_planes * rvlen; i += nthreads) {
      const int s = i / rvlen, y = i % rvlen;
      rv[i] = y < rvlen - 1
          ? (unsigned char)vbase[s * vrow_len + (n + t0 + tt - 2 - y)] : 0;
    }
    __syncthreads();
    for (int a = 0; a < a_limbs; ++a) {
      const int s = p - a;
      if (s < 0 || s >= s_planes) continue;
      const unsigned char* rvs = rv + s * rvlen + (tt - 4 - 4 * tx);
      const uint32_t* dw = d_s + a * nw;
      uint32_t w0 = *reinterpret_cast<const uint32_t*>(rvs);
      for (int jg = 0; jg < nw; ++jg) {
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(rvs + 4 * jg + 4);
        // key bytes of outputs t = t0 + 4tx + q for inputs j = 4jg .. 4jg+3
        const int v0 = (int)__funnelshift_r(w0, w1, 24);
        const int v1 = (int)__funnelshift_r(w0, w1, 16);
        const int v2 = (int)__funnelshift_r(w0, w1, 8);
        const int v3 = (int)w0;
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const int d = (int)dw[rb * a_limbs * nw + jg];
          sum[rb][0] = __dp4a(d, v0, sum[rb][0]);
          sum[rb][1] = __dp4a(d, v1, sum[rb][1]);
          sum[rb][2] = __dp4a(d, v2, sum[rb][2]);
          sum[rb][3] = __dp4a(d, v3, sum[rb][3]);
        }
        w0 = w1;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[(p * RB + rb) * tt + 4 * tx + q] = sum[rb][q];
  __syncthreads();
  for (int i = tid; i < RB * tt; i += nthreads) {
    const int rb = i / tt, tl = i % tt, b = b0 + rb;
    if (b >= batch) continue;
    unsigned long long add = 0;
    for (int pp = 0; pp < keep && 8 * (pp + limb_offset) < 64; ++pp)
      add += (unsigned long long)(long long)red[(pp * RB + rb) * tt + tl]
             << (8 * (pp + limb_offset));
    acc[((size_t)b * kp1 + cout) * n + t0 + tl] += add;
  }
}

}  // namespace

extern "C" int external_product_accumulate(
    const void* planes, const void* vv, void* acc, int batch, int levels,
    int a_limbs, int kp1, int n, int s_planes, int keep, int limb_offset,
    void* stream) {
  const int tt = n < 128 ? n : 128;
  const size_t smem = (size_t)RB * a_limbs * n + (size_t)s_planes * (n + tt)
                      + (size_t)keep * RB * tt * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      external_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n / tt, (batch + RB - 1) / RB, kp1);
  const dim3 block(tt / 4, keep);
  external_product_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int8_t*)planes, (const int8_t*)vv, (unsigned long long*)acc,
      batch, levels, a_limbs, kp1, n, s_planes, keep, limb_offset, tt);
  return (int)cudaGetLastError();
}
