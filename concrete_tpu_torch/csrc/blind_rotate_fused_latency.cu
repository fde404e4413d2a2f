// blind_rotate_fused_latency: every step of the CRT-NTT blind rotate of
// B <= 4 ciphertexts on a fused key, in one launch.
//
// Replaces, at B <= 4, the TPU kernels concrete_tpu/ops/pallas_fused_ntt.py
// blind_rotate_fused (:1223, the whole n_small-step scan in one
// pallas_call over the grid (B/R, n_small), :1299-1301) and
// concrete_tpu/ops/pallas_step.py rotate_decompose_digits (:322, the
// rotate_diff_digits front of that scan): per step i,
//
//   d[ci]  = Decomp(X^{a_i} acc - acc)                         (kernel 1)
//   res[p] = INTT_p(sum_ci NTT_p(d[ci]) (.) S_i[p, ci, :])      (kernel 3)
//   acc   += Garner(res) << t  (acc32: its top word, see garner.cuh)
//                                                               (kernel 4)
//
// and it computes the same bits as the three-kernel loop of
// ops/fused_ntt.py, whose arithmetic it shares: csrc/digits.cuh (kernel
// 1), csrc/ntt_regs.cuh's register passes on csrc/ntt.cuh's butterflies
// (kernel 3's transforms and multiply-add), csrc/garner.cuh (kernel 4).
// acc is (B, k+1, N), u32 top words (acc32) or u64; the key is the
// FusedBSK's spectra and Shoup companions (n_small, P Cin (k+1), N), row
// (p Cin + ci) (k+1) + co, Cin = l (k+1); a_t (B, n_small) int32 is the
// switched mask.
//
// Bound: latency.  At Levenshtein's shape (N = 1024, k+1 = 3, l = 2, 3
// primes) a step is 18 forward and 9 inverse transforms, 55k Shoup
// multiply-adds and 3k Garner coefficients per ciphertext: about 1.7M
// instructions, 0.05 us of the card's issue rate; it reads 442 KB of key
// spectra, 0.13 us at 3.35 TB/s.  The three-kernel loop took about 40 us
// of device time a step at B = 1 (kernel 3 36.6 us: 3 blocks of 64
// threads, its 27 transforms in sequence) and three launches.  What is
// left is a chain: the digits, one transform, the multiply-add, one
// inverse, the Garner, and the barriers between.  Design:
//  - one thread-block cluster per ciphertext, one block per (prime p,
//    output component co): P (k+1) blocks, 9 at Levenshtein's shape (up
//    to 16, the non-portable most).  Blocks of a cluster are
//    co-scheduled, so a barrier.cluster inside it cannot deadlock where a
//    grid-wide one could, and there is none;
//  - block (p, co) takes the l digit polynomials of row co (levels lev,
//    its Cin / (k+1) share of the P Cin forward transforms) and runs
//    their transforms side by side, one group of N/16 threads a level
//    (16 residues a thread, kernel 3's passes); the spectra go to its
//    shared memory, one barrier.cluster, and then every block reads the
//    Cin spectra of its prime from the k+1 blocks (p, comp) through
//    distributed shared memory for the multiply-add with its key rows,
//    spread over all its threads, 4 coefficients a thread (16-byte
//    loads); group 0 runs the one inverse transform of (p, co);
//  - its residues go to its shared memory, a second barrier.cluster, and
//    each of the P blocks (p', co) of row co recombines the whole row
//    from the P blocks' residues (Garner, P copies of a cheap phase): the
//    accumulator stays on chip across all n_small steps, row co in the
//    shared memory of each block (p', co), and no block reads another's
//    accumulator.  A split of the Garner over t would need the row's
//    slices exchanged before the next digits, a third barrier a step;
//    here every exchange is a read-after-write across blocks, one barrier
//    each, and each buffer is written again only after a barrier that
//    every reader of its last contents has passed (the spectra after the
//    residues' barrier, the residues after the next spectra's), so no
//    buffer needs a second copy;
//  - the key does not depend on the accumulator: a warp of its own stages
//    step i+1's Cin rows of block (p, co) (values and companions, 2 Cin
//    bulk copies (TMA) of N words, 48 KB at Levenshtein's shape) into a
//    2-slot ring while step i computes, counted on the slot's full
//    mbarrier; the computing warps release a slot on its empty mbarrier
//    once their multiply-add has read it (csrc/blind_rotate_latency.cu's
//    ring).
// Shared memory per block: the accumulator row (N words of 4 or 8 bytes),
// the l spectra, l pairs of N-word exchange buffers, the multiply-add's
// output and the residues (N words each), the ring (2 x 2 Cin N words)
// and its 4 mbarriers; ops/fused_latency.py's plan() computes the same sum
// and takes a shape only where it fits (not the MLP's N = 4096, l = 2:
// its ring alone is 256 KB).  The ABLATE_* switches are set only by
// chip_smoke.py's variant builds, which time the kernel without one part,
// PHASE_CLOCKS only by its instrumented build, which counts the clocks of
// each part of a step.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "banded_wgmma.cuh"   // smem_addr and the mbarrier helpers
#include "digits.cuh"
#include "garner.cuh"
#include "ntt_regs.cuh"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t FL_MAX_SMEM = 227 * 1024;   // per block, dynamic
constexpr int FL_MAX_CLUSTER = 16;           // non-portable cluster size
constexpr int FL_MAX_PRIMES = 8;             // P (k+1) <= 16, k+1 >= 2
constexpr int FL_MAX_THREADS = 288;          // ptxas: 168 registers a
                                             // thread, 168-188 bytes of
                                             // spills (512: 128, 332-352)
constexpr int FL_MAX_BATCH = 8;              // clusters, all on the card

struct FlShape {
  const int32_t* a_t;                 // (B, n_small)
  void* acc;                          // (B, k+1, N), updated in place
  const uint32_t* spec;               // (n_small, P Cin (k+1), N)
  const uint32_t* spec_sh;
  const uint2* tw;                    // (P, 2, N) twiddle pairs
  const uint32_t* pcst;               // (P, 3): p, N^-1, its companion
  const unsigned long long* gcst;     // garner.cuh's constants
  int batch, n_small, kp1, levels, base_log, n_primes, shift;
  int threads;                        // computing threads: l N / 16
  // byte offsets of the regions of shared memory (plan)
  int off_spec, off_exch, off_hat, off_res, off_ring, off_bar, ring_slot;
};

using banded::mbar_arrive;
using banded::mbar_init;
using banded::mbar_wait;
using banded::smem_addr;
using tma::bulk_copy;
using tma::cluster_barrier;
using tma::mbar_arrive_tx;

// A barrier of the computing warps (the producer warp not in it).
__device__ __forceinline__ void fl_compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

#ifdef PHASE_CLOCKS
// (chip_smoke.py's instrumented build: thread 0 of block 0 of the first
// cluster adds the clocks from one point of the step to the next into
// these, read by blind_rotate_fused_latency_phases)
__device__ unsigned long long g_fl_phase[8];
#define FL_PHASE(k)                                                       \
  do {                                                                    \
    if (tid == 0 && rank == 0 && b == 0) {                                \
      const long long now = clock64();                                    \
      g_fl_phase[k] += now - t_last;                                      \
      t_last = now;                                                       \
    }                                                                     \
  } while (0)
#else
#define FL_PHASE(k)
#endif

// ntt_regs.cuh's exchange for one group of a block that runs several
// transforms side by side: group thread g, the group's own two buffers,
// the computing threads' barrier.  A thread of another group (`active`
// false) keeps the barrier count and moves nothing.
__device__ __forceinline__ void group_exchange(uint32_t (&x)[E],
                                               uint32_t* buf, int n, int g,
                                               int& ex, int log_n, int from,
                                               int to, bool active,
                                               int threads) {
  uint32_t* b = buf + (ex++ & 1) * n;
  if (active) {
    const int ls = pass_ls(log_n, from);
#pragma unroll
    for (int k = 0; k < E; ++k) b[swz(pos(g, ls, k))] = x[k];
  }
  fl_compute_sync(threads);
  if (active) {
    const int ls = pass_ls(log_n, to);
#pragma unroll
    for (int k = 0; k < E; ++k) x[k] = b[swz(pos(g, ls, k))];
  }
}

// Block (rank, 0, b): prime pr = rank / (k+1), output component co =
// rank % (k+1) of ciphertext b, every step.
template <int LOG_N, bool ACC32>
__global__ void __launch_bounds__(FL_MAX_THREADS)
    blind_rotate_fused_latency_kernel(FlShape p) {
  using T = typename std::conditional<ACC32, uint32_t,
                                      unsigned long long>::type;
  constexpr int n = 1 << LOG_N, npass = (LOG_N + 3) / 4, TG = n / E;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.z;
  const int kp1 = p.kp1, pr = rank / kp1, co = rank - pr * kp1;
  const int cin = p.levels * kp1, ct = p.threads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* acc = reinterpret_cast<T*>(smem);                           // [N]
  uint32_t* spec_sm = reinterpret_cast<uint32_t*>(smem + p.off_spec);
  uint32_t* exch = reinterpret_cast<uint32_t*>(smem + p.off_exch);
  uint32_t* hat = reinterpret_cast<uint32_t*>(smem + p.off_hat);   // [N]
  uint32_t* res = reinterpret_cast<uint32_t*>(smem + p.off_res);   // [N]
  unsigned char* ring = smem + p.off_ring;
  const uint32_t full = smem_addr(smem + p.off_bar), empty = full + 16;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, ct / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == ct / 32) {
    // the producer: step i's 2 Cin key rows of (pr, co) into ring slot
    // i & 1, row 2 ci + (0: spectrum, 1: companions), one bulk copy each
    const int rows = 2 * cin;
    auto stage_key = [&](int i) {
      const uint32_t bar = full + 8 * (i & 1);
#ifdef ABLATE_NO_KEY
      if (lane == 0) mbar_arrive(bar);   // (no key rows: times the rest)
      return;
#endif
      if (lane == 0) mbar_arrive_tx(bar, (uint32_t)(rows * n * 4));
      __syncwarp();
      const uint32_t slot = smem_addr(ring + (size_t)(i & 1) * p.ring_slot);
      for (int r = lane; r < rows; r += 32) {
        const int ci = r >> 1;
        const size_t row =
            ((size_t)i * p.n_primes * cin + (size_t)pr * cin + ci) * kp1 +
            co;
        bulk_copy(slot + r * n * 4, (r & 1 ? p.spec_sh : p.spec) + row * n,
                  n * 4, bar);
      }
    };
    // steps 0 and 1 at once; then, during step i, step i + 1's into the
    // slot step i - 1 has left
    stage_key(0);
    if (p.n_small > 1) stage_key(1);
    for (int i = 0; i < p.n_small; ++i) {
      if (i >= 1 && i + 1 < p.n_small) {
        mbar_wait(empty + 8 * ((i + 1) & 1), ((i - 1) >> 1) & 1);
        stage_key(i + 1);
      }
      cluster_barrier();                 // step i's spectra
      cluster_barrier();                 // step i's residues
    }
    cluster_barrier();                   // the last Garner's reads
    return;
  }

  // group grp of TG threads: in the forward transforms, level grp of row
  // co; thread g of the group holds 16 residues (kernel 3's passes)
  const int grp = tid / TG, g = tid - grp * TG;
  const uint32_t pm = p.pcst[3 * pr];
  const uint32_t n_inv = p.pcst[3 * pr + 1], n_inv_sh = p.pcst[3 * pr + 2];
  const uint2* fwd = p.tw + (size_t)pr * 2 * n;
  const uint2* inv = fwd + n;
  const unsigned long long* gc = p.gcst;
  const unsigned long long p64 = gc[garner::PER_PRIME * p.n_primes];
  const unsigned long long h64 = gc[garner::PER_PRIME * p.n_primes + 1];
  const uint32_t htop = (uint32_t)gc[garner::PER_PRIME * p.n_primes + 2];
  T* acc_g = reinterpret_cast<T*>(p.acc) + ((size_t)b * kp1 + co) * n;
  uint32_t* my_exch = exch + (size_t)grp * 2 * n;
  const int ls0 = pass_ls(LOG_N, 0);     // pass 0: residue k at g + k TG
  for (int t = tid; t < n; t += ct) acc[t] = acc_g[t];
  fl_compute_sync(ct);
#ifdef PHASE_CLOCKS
  long long t_last = clock64();
#endif

  for (int i = 0; i < p.n_small; ++i) {
    int a = p.a_t[(size_t)b * p.n_small + i] % (2 * n);
    if (a < 0) a += 2 * n;

    // 1. level grp's digits of X^a acc[co] - acc[co] at pass 0's
    //    positions, as residues mod p (|d| < p), and their forward
    //    transform; the spectrum, residues 16 g .. 16 g + 15 of the
    //    bit-reversed order in thread g, into spec_sm[grp]
    uint32_t x[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int32_t d = digits::digit(
          digits::rotate_diff(acc, pos(g, ls0, k), a, n), grp, p.base_log);
      x[k] = d < 0 ? (uint32_t)(d + (int32_t)pm) : (uint32_t)d;
    }
#ifndef ABLATE_NO_TRANSFORMS
    pass<4, false>(x, g, ls0, 0, fwd, pm);
#endif
    int ex = 0;
#pragma unroll
    for (int q = 1; q < npass; ++q) {
      group_exchange(x, my_exch, n, g, ex, LOG_N, q - 1, q, true, ct);
#ifndef ABLATE_NO_TRANSFORMS
      run_pass<false>(pass_stages(LOG_N, q), x, g, pass_ls(LOG_N, q), 4 * q,
                      fwd, pm);
#endif
    }
    uint4* mine = reinterpret_cast<uint4*>(spec_sm + (size_t)grp * n) + 4 * g;
#pragma unroll
    for (int v = 0; v < E / 4; ++v)
      mine[v] = make_uint4(x[4 * v], x[4 * v + 1], x[4 * v + 2],
                           x[4 * v + 3]);
    FL_PHASE(1);
    cluster_barrier();                   // every block's spectra in
    FL_PHASE(2);

    // 2. the multiply-add over every ci = lev (k+1) + comp, spectrum lev
    //    of block (pr, comp), 4 coefficients a thread: hat = sum_ci
    //    spec[ci] (.) key[ci] (mod p), from ring slot i & 1
    mbar_wait(full + 8 * (i & 1), (i >> 1) & 1);
    FL_PHASE(3);
    const uint32_t* slot = reinterpret_cast<const uint32_t*>(
        ring + (size_t)(i & 1) * p.ring_slot);
    for (int j = tid; j < n / 4; j += ct) {
      uint32_t h[4] = {0, 0, 0, 0};
      for (int ci = 0; ci < cin; ++ci) {
        const int lev = ci / kp1, comp = ci - lev * kp1;
#ifdef ABLATE_LOCAL_SPECTRA
        // (this block's own spectra only: times the exchange's reads)
        const uint4 dv = reinterpret_cast<const uint4*>(
            spec_sm + (size_t)lev * n)[j];
#else
        const uint4 dv = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(spec_sm + (size_t)lev * n,
                                    pr * kp1 + comp))[j];
#endif
        const uint4 kv =
            reinterpret_cast<const uint4*>(slot + (size_t)(2 * ci) * n)[j];
        const uint4 ks = reinterpret_cast<const uint4*>(
            slot + (size_t)(2 * ci + 1) * n)[j];
        h[0] = ntt::mul_add(h[0], dv.x, kv.x, ks.x, pm);
        h[1] = ntt::mul_add(h[1], dv.y, kv.y, ks.y, pm);
        h[2] = ntt::mul_add(h[2], dv.z, kv.z, ks.z, pm);
        h[3] = ntt::mul_add(h[3], dv.w, kv.w, ks.w, pm);
      }
      reinterpret_cast<uint4*>(hat)[j] = make_uint4(h[0], h[1], h[2], h[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (i & 1));   // slot i & 1 read
    fl_compute_sync(ct);
    FL_PHASE(4);

    // 3. group 0: the inverse transform of hat, scaled by 1/N, into res
    //    in natural order (pass 0's positions)
    const bool inv_group = grp == 0;
    if (inv_group) {
      const uint4* src = reinterpret_cast<const uint4*>(hat) + 4 * g;
#pragma unroll
      for (int v = 0; v < E / 4; ++v) {
        const uint4 w4 = src[v];
        x[4 * v] = w4.x;
        x[4 * v + 1] = w4.y;
        x[4 * v + 2] = w4.z;
        x[4 * v + 3] = w4.w;
      }
    }
#pragma unroll
    for (int q = npass - 1; q >= 0; --q) {
      if (q < npass - 1)
        group_exchange(x, exch, n, g, ex, LOG_N, q + 1, q, inv_group, ct);
#ifndef ABLATE_NO_TRANSFORMS
      if (inv_group)
        run_pass<true>(pass_stages(LOG_N, q), x, g, pass_ls(LOG_N, q), 4 * q,
                       inv, pm);
#endif
    }
    if (inv_group) {
#pragma unroll
      for (int k = 0; k < E; ++k)
        res[pos(g, ls0, k)] = ntt::shoup_mul(x[k], n_inv, n_inv_sh, pm);
    }
    FL_PHASE(5);
    cluster_barrier();                   // every block's residues in
    FL_PHASE(6);

    // 4. the Garner of row co, every coefficient, 4 a thread, from the
    //    residues of the P blocks (p', co)
#ifndef ABLATE_NO_GARNER
    for (int j = tid; j < n / 4; j += ct) {
      uint4 r4[FL_MAX_PRIMES];
#pragma unroll
      for (int q = 0; q < FL_MAX_PRIMES; ++q)
        if (q < p.n_primes)
          r4[q] = reinterpret_cast<const uint4*>(
              cluster.map_shared_rank(res, q * kp1 + co))[j];
      unsigned long long w[4] = {0, 0, 0, 0};
      double frac[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int q = 0; q < FL_MAX_PRIMES; ++q) {
        if (q < p.n_primes) {
          const unsigned long long* c = gc + garner::PER_PRIME * q;
          garner::add_residue(w[0], frac[0], r4[q].x, c);
          garner::add_residue(w[1], frac[1], r4[q].y, c);
          garner::add_residue(w[2], frac[2], r4[q].z, c);
          garner::add_residue(w[3], frac[3], r4[q].w, c);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned long long z = garner::recombined(w[e], frac[e], p64);
        if (ACC32)
          acc[4 * j + e] = (T)garner::add_top((uint32_t)acc[4 * j + e], z,
                                              p.shift, htop);
        else
          acc[4 * j + e] = (T)garner::add_full(acc[4 * j + e], z, p.shift,
                                               h64);
      }
    }
#endif
    fl_compute_sync(ct);                 // row co whole for the digits
    FL_PHASE(7);
  }
  cluster_barrier();                     // no block reads our residues now
  if (pr == 0)
    for (int t = tid; t < n; t += ct) acc_g[t] = acc[t];
}

// The plan: ops/fused_latency.py plan() computes the same numbers.
struct FlPlan {
  int cluster, threads;
  int off_spec, off_exch, off_hat, off_res, off_ring, off_bar, ring_slot;
  size_t smem;
};

bool make_plan(FlPlan& pl, int batch, int log_n, int kp1, int levels,
               int n_primes, bool acc32) {
  if (batch < 1 || batch > FL_MAX_BATCH || log_n < 10 || log_n > 12 ||
      kp1 < 1 || levels < 1 || n_primes < 1 || n_primes > FL_MAX_PRIMES)
    return false;
  const size_t n = (size_t)1 << log_n, cin = (size_t)levels * kp1;
  pl.cluster = n_primes * kp1;
  pl.threads = levels * (int)(n / E);
  if (pl.cluster > FL_MAX_CLUSTER || pl.threads + 32 > FL_MAX_THREADS)
    return false;
  size_t off = n * (acc32 ? 4 : 8);            // the accumulator row
  pl.off_spec = (int)off;
  off += levels * n * 4;                       // this block's spectra
  pl.off_exch = (int)off;
  off += levels * 2 * n * 4;                   // the exchange buffers
  pl.off_hat = (int)off;
  off += n * 4;                                // the multiply-add's sums
  pl.off_res = (int)off;
  off += n * 4;                                // the residues
  pl.off_ring = (int)off;
  pl.ring_slot = (int)(2 * cin * n * 4);
  off += 2 * (size_t)pl.ring_slot;             // the key ring
  pl.off_bar = (int)off;
  pl.smem = off + 32;                          // its 4 mbarriers
  return pl.smem <= FL_MAX_SMEM;
}

template <int LOG_N, bool ACC32>
cudaError_t launch(const FlPlan& pl, const FlShape& p, void* stream) {
  auto kernel = blind_rotate_fused_latency_kernel<LOG_N, ACC32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  if (pl.cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, 1, p.batch);
  cfg.blockDim = dim3(pl.threads + 32);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// a_t (B, n_small) int32; acc (B, k+1, N) u32 top words (acc32) or u64,
// the first accumulator, overwritten by the last; spec, spec_sh the
// FusedBSK's (n_small, P Cin (k+1), N) u32, 16-byte aligned; tw the
// twiddle pairs (P, 2, N) of ops/ntt.pair_tables; pcst (P, 3) u32
// (ops/ntt.prime_constants); gcst garner.cuh's constants; trunc_bits the
// key's truncation t.
extern "C" int blind_rotate_fused_latency(
    const void* a_t, void* acc, const void* spec, const void* spec_sh,
    const void* tw, const void* pcst, const void* gcst, int batch,
    int n_small, int kp1, int levels, int base_log, int n_primes, int log_n,
    int trunc_bits, int acc32, void* stream) {
  FlPlan pl{};
  if (n_small < 1 || base_log < 1 || levels * base_log > (acc32 ? 31 : 63) ||
      trunc_bits < 0 || trunc_bits > 63 || (uintptr_t)spec % 16 ||
      (uintptr_t)spec_sh % 16 ||
      !make_plan(pl, batch, log_n, kp1, levels, n_primes, acc32 != 0))
    return (int)cudaErrorInvalidValue;
  FlShape p{};
  p.a_t = (const int32_t*)a_t;
  p.acc = acc;
  p.spec = (const uint32_t*)spec;
  p.spec_sh = (const uint32_t*)spec_sh;
  p.tw = (const uint2*)tw;
  p.pcst = (const uint32_t*)pcst;
  p.gcst = (const unsigned long long*)gcst;
  p.batch = batch;
  p.n_small = n_small;
  p.kp1 = kp1;
  p.levels = levels;
  p.base_log = base_log;
  p.n_primes = n_primes;
  p.shift = trunc_bits;
  p.threads = pl.threads;
  p.off_spec = pl.off_spec;
  p.off_exch = pl.off_exch;
  p.off_hat = pl.off_hat;
  p.off_res = pl.off_res;
  p.off_ring = pl.off_ring;
  p.off_bar = pl.off_bar;
  p.ring_slot = pl.ring_slot;
#define FL_CASE(L)                                                          \
  case L:                                                                   \
    return (int)(acc32 ? launch<L, true>(pl, p, stream)                     \
                       : launch<L, false>(pl, p, stream));
  switch (log_n) {
    FL_CASE(10) FL_CASE(11) FL_CASE(12)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FL_CASE
}

#ifdef PHASE_CLOCKS
// The instrumented build's clocks per phase (8), summed over its launches
// since the last call, which zeroes them.
extern "C" int blind_rotate_fused_latency_phases(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_fl_phase, sizeof(g_fl_phase));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_fl_phase, zero, sizeof(zero));
}
#endif
