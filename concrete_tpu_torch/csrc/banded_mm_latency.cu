// banded_matmul, latency form: the same product as banded_mm.cu for at
// most 8 lhs rows, the shape of the latency blind rotate (B <= 4), where
// the k+1 rows of the BSK step are the lhs and the batch is Cout:
//
//   out[r, b, a + s, t] = sum_{ci, j} lhs[a, r, ci, j] * E_s(b, ci, t - j)
//
// for t, j in [0, N), with E_s(b, ci, u) = limb s of
//  - the negacyclic extension of kernel 1's int32 digits (the latency
//    step): d[b, ci, u] for u >= 0 and -d[b, ci, N + u] for u < 0, split
//    into balanced base-256 limbs after the negation (the JAX package's
//    ext_d = [-d[1:], d] then i32_digits_to_balanced_i8); the digits are
//    kernel 1's output (l, (k+1)*B, N) read in place, whose rows (lev, r,
//    b) are (ci, b) with ci = lev*(k+1) + r;
//  - or an int8 band vv[ci, b, s, N-1+u] given as it is (the generic
//    banded_matmul with few rows).
// lhs[a, r, ci, j] is read in place through byte strides: the BSK step's
// raw limb rows w_vv[ci, r, a, N-1 + j] of the packed key, the JAX
// package's stacked lhs, or kernel A's digit planes.
//
// Replaces the TPU kernel concrete_tpu/ops/pallas_banded_mm.py
// banded_matmul_fused (:88) at the shape concrete_tpu/core/kernels.py
// _blind_rotate_xla_latency gives negacyclic_banded_matmul_planes, with
// the glue of that step (ext_d, the limb split, the lhs transposes).
//
// Bound: bytes, and in practice latency.  At B=1, k+1 = 2, l = 4, N=1024,
// 4 kept key limbs and 1 digit limb the kernel reads 64 KB of key rows and
// 32 KB of digits and writes 32 KB: 0.04 us at 3.35 TB/s, against 2.1e8
// useful MACs (0.2 us at the int8 peak).  What costs is the chain: a
// launch, a load from memory, the MMAs, a store.  Design:
//  - rows on the MMA's n side: mma.sync m16n8k32 with M = 16 outputs t per
//    warp, K = 32 j, and n = the (r, a) pairs of lhs rows and key limbs,
//    padded to 8 (k+1 = 2 rows x 4 limbs fill all 8 at the latency shape);
//  - the band built in registers: each band word is built from 4
//    consecutive digits (16-byte loads), negated when they lie at u < 0
//    (u = 0 starts a word, so a word never straddles the sign), then split
//    into limbs: byte = x & 0xFF, x = (x - (int8)byte) >> 8.  A thread
//    builds two neighbouring words and stores their 4 byte-shifted,
//    byte-reversed views, so each A-fragment register (4 consecutive j at
//    one t, bytes reversed) is one shared-memory load of the view its
//    shift picks (a funnel shift and a byte permute per register cost
//    1.8 us of 10 in the first design: tools/ablate_kernels.py);
//  - split K = Cin*N across the blocks of a thread-block cluster (up to 8,
//    one K slice of up to 1024 j of one ci each at the latency shape), and
//    each slice's k-steps across two halves of the block's 8 warps, so
//    that 16 t-tiles x 8 slices x B blocks run at once and each warp runs
//    a 16-step MMA chain.  A block stages its whole slice at once (key rows
//    by 16-byte cp.async from the 16-byte boundary below each row, band
//    words by plain loads), waits once, and runs its k-steps with no
//    further barrier;
//  - the int32 partial tiles (t x (r, a) per digit limb and K half) meet
//    through distributed shared memory: after a cluster barrier each block
//    sums a share of the outputs over every block's tiles, its remote
//    loads issued together, and stores it once, so no memset and no
//    atomics are needed.  int32 sums wrap as the MXU's do and stay far
//    below 2^31 (Cin*N*128*128 = 1.3e8); no .satfinite.
// The ABLATE_* switches are set only by tools/ablate_kernels.py's variant
// builds: each leaves one part of the work out, to time it.
// The band build, the lhs staging and the fragment build and MMA chain
// are device functions of banded_latency.cuh, which the persistent latency
// blind rotate (blind_rotate_latency.cu) runs with the same arithmetic.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_latency.cuh"  // LatShape, stage_band, stage_lhs, mma_chain

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_CL = 8;         // blocks per cluster (the portable most)
constexpr size_t MAX_SMEM = 227 * 1024;   // per block, dynamic

// Block (rank, t0 / LT, b): rank takes the K slices rank, rank + cl, ...
template <bool DIGITS>
__global__ void __launch_bounds__(THREADS) banded_latency_kernel(
    LatShape sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int t0 = blockIdx.y * LT, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, kh = tid >> 7;   // t rows, K half
  const int g = lane >> 2, tg = lane & 3;
  const int ncp = sh.ntiles * 8;
  const int tile_cells = sh.s_planes * ncp * LT;
  int* red = reinterpret_cast<int*>(smem);          // [KH][S][ncp][LT]
  unsigned char* slots = smem + (size_t)KH * tile_cells * 4;
  // this thread's cells of its K half's partial tiles: the C fragment's
  // rows g, g+8 of the warp's 16 t and columns 2tg, 2tg+1 of each n tile
  auto cell = [&](int s, int nt, int i) {
    return kh * tile_cells + (s * ncp + nt * 8 + 2 * tg + (i & 1)) * LT +
           16 * warp + g + 8 * (i >> 1);
  };
  for (int s = 0; s < sh.s_planes; ++s)
    for (int nt = 0; nt < sh.ntiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[cell(s, nt, i)] = 0;

  const int mine = (sh.slices - rank + sh.cl - 1) / sh.cl;
  for (int r0 = 0; r0 < mine; r0 += sh.per_round) {
    const int nk = min(sh.per_round, mine - r0);
    if (r0) __syncthreads();                 // the last round's reads done
    for (int k = 0; k < nk; ++k) {
      const int sl = rank + sh.cl * (r0 + k);
      const int ci = sl / sh.jblocks, jb = sl - ci * sh.jblocks;
      unsigned char* slot = slots + (size_t)k * sh.slice_bytes;
      stage_band<DIGITS>(sh, reinterpret_cast<uint32_t*>(slot), ci, jb, t0,
                         b);
      stage_lhs(sh, slot + sh.band_bytes, ci, jb);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // y0: the band row of the warp's thread at k-step 0 (mma_chain); this
    // warp's K half runs k-steps [ks0, ks0 + half)
    const int y0 = 16 * warp + g - 4 * tg + sh.js - 3;
    const int half = sh.js / 32 / KH, ks0 = kh * half;
    for (int s = 0; s < sh.s_planes; ++s) {
      for (int nt = 0; nt < sh.ntiles; ++nt) {
        const int c = nt * 8 + g;
        int acc[4] = {0, 0, 0, 0};
        for (int k = 0; k < nk; ++k) {
          const int sl = rank + sh.cl * (r0 + k);
          const int ci = sl / sh.jblocks, jb = sl - ci * sh.jblocks;
          const unsigned char* slot = slots + (size_t)k * sh.slice_bytes;
          const uint32_t* band = reinterpret_cast<const uint32_t*>(slot) +
                                 (4 * s + (y0 & 3)) * sh.band_words;
          mma_chain(acc, band, slot + sh.band_bytes, sh, c, ci, jb, y0, tg,
                    ks0, half);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) red[cell(s, nt, i)] += acc[i];
      }
    }
  }

  // out[r, b, p, t0 + tl] = sum over the cluster's blocks, the K halves
  // and the limb pairs a + s = p of their partials; each block takes a
  // share, its remote loads for one pair issued together
  const int n_out = sh.a_limbs + sh.s_planes - 1;
  const int total = sh.rows * n_out * LT;
#ifdef ABLATE_NO_DSMEM
  // (leaves the cluster's reduction out: each block stores its own sums)
  for (int e = tid; e < total; e += THREADS) {
    const int tl = e % LT, rp = e / LT, p = rp % n_out, r = rp / n_out;
    int sum = 0;
    for (int s = 0; s < sh.s_planes; ++s) {
      const int a = p - s;
      if (a >= 0 && a < sh.a_limbs)
        for (int h = 0; h < KH; ++h)
          sum += red[h * tile_cells + (s * ncp + r * sh.a_limbs + a) * LT +
                     tl];
    }
    if (rank == 0)
      sh.out[((size_t)(r * sh.batch + b) * n_out + p) * sh.n + t0 + tl] = sum;
  }
#else
  cluster.sync();                            // every block's partials in
  for (int e = rank * THREADS + tid; e < total; e += sh.cl * THREADS) {
    const int tl = e % LT, rp = e / LT, p = rp % n_out, r = rp / n_out;
    int sum = 0;
    for (int s = 0; s < sh.s_planes; ++s) {
      const int a = p - s;
      if (a < 0 || a >= sh.a_limbs) continue;
      const int off = (s * ncp + r * sh.a_limbs + a) * LT + tl;
      int part[MAX_CL][KH];
#pragma unroll
      for (int rr = 0; rr < MAX_CL; ++rr) {
        const int* rred =
            cluster.map_shared_rank(red, rr < sh.cl ? rr : 0) + off;
#pragma unroll
        for (int h = 0; h < KH; ++h)
          part[rr][h] = rr < sh.cl ? rred[h * tile_cells] : 0;
      }
#pragma unroll
      for (int rr = 0; rr < MAX_CL; ++rr)
#pragma unroll
        for (int h = 0; h < KH; ++h) sum += part[rr][h];
    }
    sh.out[((size_t)(r * sh.batch + b) * n_out + p) * sh.n + t0 + tl] = sum;
  }
  cluster.sync();                            // no block leaves while read
#endif
}

}  // namespace

extern "C" int banded_matmul_latency(
    const void* lhs, const void* lhs_end, long long st_a, long long st_r,
    long long st_lev, long long st_rin, const void* digits, const void* vv,
    void* out, int a_limbs, int rows, int cin, int kp1, int batch,
    int s_planes, int n, void* stream) {
  if (n % LT || rows < 1 || batch < 1 || batch > 65535 || s_planes < 1)
    return (int)cudaErrorInvalidValue;
  LatShape sh{};
  sh.lhs = (const int8_t*)lhs;
  sh.lhs_end = (const int8_t*)lhs_end;
  sh.st_a = st_a; sh.st_r = st_r; sh.st_lev = st_lev; sh.st_rin = st_rin;
  sh.digits = (const int32_t*)digits;
  sh.vv = (const int8_t*)vv;
  sh.out = (int*)out;
  sh.a_limbs = a_limbs; sh.rows = rows; sh.cin = cin; sh.kp1 = kp1;
  sh.batch = batch; sh.s_planes = s_planes; sh.n = n;
  sh.js = JS_MAX;                            // the largest divisor of N
  while (n % sh.js) sh.js /= 2;              // ... down to LT
  sh.jblocks = n / sh.js;
  sh.slices = cin * sh.jblocks;
  sh.cl = sh.slices < MAX_CL ? sh.slices : MAX_CL;
  sh.ncols = rows * a_limbs;
  sh.ntiles = (sh.ncols + 7) / 8;
  sh.band_words = (sh.js + LT) / 4 + 1;
  sh.band_bytes = (4 * s_planes * sh.band_words * 4 + 15) / 16 * 16;
  sh.lhs_row = sh.js + 16;
  sh.slice_bytes = sh.band_bytes + sh.ncols * sh.lhs_row;
  const size_t red = (size_t)KH * s_planes * sh.ntiles * 8 * LT * 4;
  const int mine = (sh.slices + sh.cl - 1) / sh.cl;
  if (red + sh.slice_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  sh.per_round = (int)((MAX_SMEM - red) / sh.slice_bytes);
  if (sh.per_round > mine) sh.per_round = mine;
  const size_t smem = red + (size_t)sh.per_round * sh.slice_bytes;

  void (*kernel)(LatShape) = digits ? &banded_latency_kernel<true>
                                    : &banded_latency_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.cl, n / LT, batch);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
