// blind_rotate_crt_scan: every step of the CRT-NTT blind rotate of a batch
// of ciphertexts on a fused key, in one launch: the throughput form of the
// one-call scan.
//
// Replaces no TPU kernel alone.  It is the batch form of the TPU kernel
// concrete_tpu/ops/pallas_fused_ntt.py blind_rotate_fused (:1223, the whole
// n_small-step scan in one pallas_call over the grid (B/R, n_small),
// :1299-1301), whose front is concrete_tpu/ops/pallas_step.py
// rotate_decompose_digits (:322).  The port ran it as a host loop of three
// launches a step (ops/fused_ntt.py scan_steps: kernel 1, digits; kernel 3,
// the external product per prime; kernel 4, Garner and the update) and, at
// B <= 4, as csrc/blind_rotate_fused_latency.cu, which spends a cluster of
// P (k+1) blocks on one ciphertext for latency.  Per step i,
//
//   d[ci]  = Decomp(X^{a_i} acc - acc)                         (kernel 1)
//   res[p] = INTT_p(sum_ci NTT_p(d[ci]) (.) S_i[p, ci, :])      (kernel 3)
//   acc   += Garner(res) << t  (acc32: its top word, see garner.cuh)
//                                                               (kernel 4)
//
// with the same bits as the loop, whose arithmetic it shares:
// csrc/digits.cuh (in 32 bits in the acc32 mode, digit_top),
// csrc/ntt_regs.cuh's register passes on csrc/ntt.cuh's butterflies and
// kernel 3's multiply-add (csrc/crt_external_product.cuh mac16),
// csrc/garner.cuh.  acc is (B, k+1, N), u32 top words (acc32) or u64; the
// key is the FusedBSK's spectra and Shoup companions (n_small, P Cin (k+1),
// N), row (p Cin + ci) (k+1) + co, Cin = l (k+1); a_t (B, n_small) int32 is
// the switched mask.  k+1 = 2, N = 2048, P <= 3 (ops/crt_scan.py plan,
// make_plan below).
//
// Bound: operations, as kernel 3's.  At the key-value query's shape (N =
// 2048, k+1 = 2, l = 1, 3 primes, acc32) a ciphertext's step is 12
// transforms of 11,264 butterflies, 24,576 Shoup multiply-adds, 12,288
// digits (every prime's group takes its own) and 4,096 Garner
// coefficients of 3 residues; the step's key spectra (196 KB) are read by
// every ciphertext through L2.  The loop spent 27% of its device time
// beside the transforms: kernel 1 wrote the digits and kernel 3 the
// residues to device memory, kernel 4 read them back with the
// accumulator, 235 MB a step at B = 2,048, and the host launched three
// kernels a step.  Design:
//  - one block per ciphertext of P groups of N/16 threads, group p the
//    prime p's transforms (16 residues a thread, kernel 3's passes: the
//    block (ciphertext, prime) of kernel 3 is a group here).  Nothing
//    synchronises across blocks: a ciphertext's scan reads only its own
//    accumulator, its own a_t row and the key;
//  - the accumulator stays in shared memory from the first step to the
//    last; each group computes the digits it transforms from it straight
//    into the first forward pass's registers, runs the multiply-add with
//    the step's spectra read through __ldg as kernel 3 does, and inverts;
//    the residues go to its pair of exchange buffers, the last exchange
//    read (a barrier);
//  - then every thread of the block recombines (Garner) quads of the
//    (k+1) N coefficients from the P groups' residues, once a coefficient,
//    and updates the accumulator in place; a barrier, and the next step.
//    Every exchange is within the block: __syncthreads, no cluster.
//  - A cluster of P blocks a ciphertext (a block a prime, the Garner split
//    over the blocks through distributed shared memory, two cluster
//    barriers a step) was measured first, on an H100 SXM at 700 W: 373.7
//    ms against the loop's 308.8 at B = 2,048 (PERF.md), its cross-block
//    Garner about 50 ms of it, 163 clusters on the card at once (13 waves
//    of 2,048), and 128 registers a thread (four blocks an SM) left it
//    spilling.  One block
//    of 3 groups holds 384 threads at 168 registers without spills, one
//    block an SM, and the Garner reads local shared memory.
//  - shared memory: the accumulator ((k+1) N words of 4 or 8 bytes) and P
//    pairs of N-word exchange buffers: 64 KB at the key-value query's
//    shape.  P N/16 threads at no fewer than 168 registers fit an SM's
//    65,536 at N = 2048 and P <= 3 only: the rule takes those shapes.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "crt_external_product.cuh"   // mac16, and ntt_regs.cuh's passes
#include "digits.cuh"
#include "garner.cuh"

namespace {

constexpr size_t CS_MAX_SMEM = 227 * 1024;   // per block, dynamic
constexpr int CS_MAX_PRIMES = 3;             // groups of N/16 a block
constexpr int CS_KP1 = KR;                   // k+1 = 2: both in registers
constexpr int CS_LOG_N = 11;                 // N = 2048

struct CsShape {
  const int32_t* a_t;                 // (B, n_small)
  void* acc;                          // (B, k+1, N), updated in place
  const uint32_t* spec;               // (n_small, P Cin (k+1), N)
  const uint32_t* spec_sh;
  const uint2* tw;                    // (P, 2, N) twiddle pairs
  const uint32_t* pcst;               // (P, 3): p, N^-1, its companion
  const unsigned long long* gcst;     // garner.cuh's constants
  int n_small, levels, base_log, n_primes, shift;
  int off_exch;                       // byte offset of the exchange buffers
};

// `v`, as the compiler must take it to be another value each time: what is
// computed from it (a twiddle pair's or a Garner constant's load, an
// exchange address) stays where it is used.  Without it the compiler
// hoists all of them out of the step loop (none changes from step to step)
// and keeps them in registers: 240 registers a thread, or hundreds of
// bytes of spills at fewer.
template <typename V>
__device__ __forceinline__ V opaque(V v) {
  if constexpr (sizeof(V) == 8)
    asm volatile("" : "+l"(v));
  else
    asm volatile("" : "+r"(v));
  return v;
}

// ntt_regs.cuh's exchange for thread g of a group (one group a thread) in
// the group's own pair of buffers: one barrier of the block.
__device__ __forceinline__ void exchange_g(uint32_t (&x)[E], uint32_t* buf,
                                           int n, int g, int& ex, int log_n,
                                           int from, int to) {
  uint32_t* b = buf + (ex++ & 1) * n;
  const int ls_from = pass_ls(log_n, from), ls_to = pass_ls(log_n, to);
#pragma unroll
  for (int k = 0; k < E; ++k) b[swz(pos(g, ls_from, k))] = x[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < E; ++k) x[k] = b[swz(pos(g, ls_to, k))];
}

// Garner of the accumulator's quad j, in place: the new words from the
// quad's residues r4[q] of the P primes and the old words acc[4j..4j+3].
template <typename T>
__device__ __forceinline__ void garner_quad(
    T* acc, int j, const uint4 (&r4)[CS_MAX_PRIMES],
    const unsigned long long* gc, int n_primes, int shift) {
  unsigned long long w[4] = {0, 0, 0, 0};
  double frac[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int q = 0; q < CS_MAX_PRIMES; ++q) {
    if (q < n_primes) {
      const unsigned long long* c = gc + garner::PER_PRIME * q;
      garner::add_residue(w[0], frac[0], r4[q].x, c);
      garner::add_residue(w[1], frac[1], r4[q].y, c);
      garner::add_residue(w[2], frac[2], r4[q].z, c);
      garner::add_residue(w[3], frac[3], r4[q].w, c);
    }
  }
  const unsigned long long* top = gc + garner::PER_PRIME * n_primes;
  const unsigned long long p64 = __ldg(top);
  T v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned long long z = garner::recombined(w[e], frac[e], p64);
    if constexpr (sizeof(T) == 4)
      v[e] = garner::add_top(acc[4 * j + e], z, shift,
                             (uint32_t)__ldg(top + 2));
    else
      v[e] = garner::add_full(acc[4 * j + e], z, shift, __ldg(top + 1));
  }
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(acc + 4 * j) = make_uint4(v[0], v[1], v[2],
                                                        v[3]);
  } else {
    ulonglong2* d = reinterpret_cast<ulonglong2*>(acc + 4 * j);
    d[0] = make_ulonglong2(v[0], v[1]);
    d[1] = make_ulonglong2(v[2], v[3]);
  }
}

// Block b: ciphertext b, every step; group gp of TH threads the prime gp.
// At most CS_MAX_PRIMES groups, so a thread keeps 168 registers.
template <int LOG_N, bool ACC32>
__global__ void __launch_bounds__(CS_MAX_PRIMES * ((1 << LOG_N) / E), 1)
    crt_external_product_kernel_scan(CsShape p) {
  using T = typename std::conditional<ACC32, uint32_t,
                                      unsigned long long>::type;
  constexpr int n = 1 << LOG_N, npass = (LOG_N + 3) / 4, TH = n / E;
  constexpr int ls0 = LOG_N - 4;       // pass 0: residue k at g + k TH
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, gp = tid / TH, g0 = tid - gp * TH;
  const int threads = p.n_primes * TH, b = blockIdx.x;
  T* acc = reinterpret_cast<T*>(smem);                     // [k+1][N]
  // [P][2][N]: group p's exchange buffers, and after each step's last
  // exchange its prime's k+1 residue rows
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem + p.off_exch);
  uint32_t* buf = bufs + (size_t)gp * 2 * n;
  T* acc_g = reinterpret_cast<T*>(p.acc) + (size_t)b * CS_KP1 * n;
  for (int t = tid; t < CS_KP1 * n; t += threads) acc[t] = acc_g[t];
  __syncthreads();
  const uint2* fwd0 = p.tw + (size_t)gp * 2 * n;
  const int32_t* a_row = p.a_t + (size_t)b * p.n_small;
  int ex = 0, a_next = __ldg(a_row);

  for (int i = 0; i < p.n_small; ++i) {
    const int cin = p.levels * CS_KP1;
    const uint32_t pm = __ldg(p.pcst + 3 * gp);
    int a = a_next % (2 * n);
    if (a < 0) a += 2 * n;
    if (i + 1 < p.n_small) a_next = __ldg(a_row + i + 1);   // one step ahead
    const size_t step_words = (size_t)p.n_primes * cin * CS_KP1 << LOG_N;
    const uint32_t* spec = p.spec + (size_t)i * step_words;
    const uint32_t* spec_sh = p.spec_sh + (size_t)i * step_words;

    // 1. per digit polynomial ci = lev (k+1) + comp: level lev's digits
    //    of X^a acc[comp] - acc[comp] as residues mod p (|d| < p), the
    //    forward transform, and the multiply-add into both outputs
    uint32_t hat[CS_KP1][E];
#pragma unroll
    for (int co = 0; co < CS_KP1; ++co)
#pragma unroll
      for (int k = 0; k < E; ++k) hat[co][k] = 0;
    for (int ci = 0; ci < cin; ++ci) {
      const int g = opaque(g0);
      const uint2* fwd = opaque(fwd0);
      const int lev = ci / CS_KP1, comp = ci - lev * CS_KP1;
      const T* row = acc + comp * n;
      uint32_t x[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        int32_t d;
        if constexpr (ACC32)
          d = digits::digit_top(
              digits::rotate_diff_top(row, g + k * TH, a, n), lev,
              p.base_log);
        else
          d = digits::digit(digits::rotate_diff(row, g + k * TH, a, n), lev,
                            p.base_log);
        x[k] = d < 0 ? (uint32_t)(d + (int32_t)pm) : (uint32_t)d;
      }
      pass<4, false>(x, g, ls0, 0, fwd, pm);
#pragma unroll
      for (int q = 1; q < npass; ++q) {
        exchange_g(x, buf, n, g, ex, LOG_N, q - 1, q);
        run_pass<false>(pass_stages(LOG_N, q), x, g, pass_ls(LOG_N, q),
                        4 * q, fwd, pm);
      }
      // thread g holds spectrum residues 16 g .. 16 g + 15
      const size_t key = (size_t)(gp * cin + ci) * CS_KP1 * n;
#pragma unroll
      for (int co = 0; co < CS_KP1; ++co)
        mac16(hat[co], x, spec + key + (size_t)co * n,
              spec_sh + key + (size_t)co * n, E * g, pm);
    }

    // 2. the inverse transforms, scaled by 1/N, and the residues in
    //    natural order into the group's buffers once the last exchange is
    //    read
#pragma unroll
    for (int co = 0; co < CS_KP1; ++co) {
      const int g = opaque(g0);
      const uint2* inv = opaque(fwd0) + n;
#pragma unroll
      for (int q = npass - 1; q >= 0; --q) {
        if (q < npass - 1) exchange_g(hat[co], buf, n, g, ex, LOG_N, q + 1, q);
        run_pass<true>(pass_stages(LOG_N, q), hat[co], g, pass_ls(LOG_N, q),
                       4 * q, inv, pm);
      }
    }
    __syncthreads();
    {
      const int g = opaque(g0);
      const uint32_t n_inv = __ldg(p.pcst + 3 * gp + 1);
      const uint32_t n_inv_sh = __ldg(p.pcst + 3 * gp + 2);
#pragma unroll
      for (int co = 0; co < CS_KP1; ++co)
#pragma unroll
        for (int k = 0; k < E; ++k)
          buf[co * n + g + k * TH] =
              ntt::shoup_mul(hat[co][k], n_inv, n_inv_sh, pm);
    }
    __syncthreads();

    // 3. the Garner of every quad by every thread, from the P groups'
    //    residues, the accumulator updated in place
    {
      const unsigned long long* gc = opaque(p.gcst);
      for (int j = tid; j < CS_KP1 * n / 4; j += threads) {
        uint4 r4[CS_MAX_PRIMES];
#pragma unroll
        for (int q = 0; q < CS_MAX_PRIMES; ++q)
          if (q < p.n_primes)
            r4[q] = reinterpret_cast<const uint4*>(bufs + (size_t)q * 2 * n)[j];
        garner_quad(acc, j, r4, gc, p.n_primes, p.shift);
      }
    }
    __syncthreads();
  }
  for (int t = tid; t < CS_KP1 * n; t += threads) acc_g[t] = acc[t];
}

// The plan: ops/crt_scan.py plan() computes the same numbers.
struct CsPlan {
  int threads, off_exch;
  size_t smem;
};

bool make_plan(CsPlan& pl, int batch, int log_n, int kp1, int levels,
               int n_primes, bool acc32) {
  if (batch < 1 || log_n != CS_LOG_N || kp1 != CS_KP1 || levels < 1 ||
      n_primes < 1 || n_primes > CS_MAX_PRIMES)
    return false;
  const size_t n = (size_t)1 << log_n;
  pl.threads = n_primes * (int)(n / E);
  pl.off_exch = (int)(kp1 * n * (acc32 ? 4 : 8));     // the accumulator
  pl.smem = pl.off_exch + (size_t)n_primes * 2 * n * 4;  // the exchanges
  return pl.smem <= CS_MAX_SMEM;
}

template <int LOG_N, bool ACC32>
cudaError_t launch_scan(const CsPlan& pl, const CsShape& p, int batch,
                        void* stream) {
  auto kernel = crt_external_product_kernel_scan<LOG_N, ACC32>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch, pl.threads, pl.smem, (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// a_t (B, n_small) int32; acc (B, k+1, N) u32 top words (acc32) or u64,
// the first accumulator, overwritten by the last; spec, spec_sh the
// FusedBSK's (n_small, P Cin (k+1), N) u32, 16-byte aligned; tw the
// twiddle pairs (P, 2, N) of ops/ntt.pair_tables; pcst (P, 3) u32
// (ops/ntt.prime_constants); gcst garner.cuh's constants; trunc_bits the
// key's truncation t.
extern "C" int blind_rotate_crt_scan(
    const void* a_t, void* acc, const void* spec, const void* spec_sh,
    const void* tw, const void* pcst, const void* gcst, int batch,
    int n_small, int kp1, int levels, int base_log, int n_primes, int log_n,
    int trunc_bits, int acc32, void* stream) {
  CsPlan pl{};
  if (n_small < 1 || base_log < 1 || levels * base_log > (acc32 ? 31 : 63) ||
      trunc_bits < 0 || trunc_bits > 63 || (uintptr_t)spec % 16 ||
      (uintptr_t)spec_sh % 16 ||
      !make_plan(pl, batch, log_n, kp1, levels, n_primes, acc32 != 0))
    return (int)cudaErrorInvalidValue;
  CsShape p{};
  p.a_t = (const int32_t*)a_t;
  p.acc = acc;
  p.spec = (const uint32_t*)spec;
  p.spec_sh = (const uint32_t*)spec_sh;
  p.tw = (const uint2*)tw;
  p.pcst = (const uint32_t*)pcst;
  p.gcst = (const unsigned long long*)gcst;
  p.n_small = n_small;
  p.levels = levels;
  p.base_log = base_log;
  p.n_primes = n_primes;
  p.shift = trunc_bits;
  p.off_exch = pl.off_exch;
  return (int)(acc32 ? launch_scan<CS_LOG_N, true>(pl, p, batch, stream)
                     : launch_scan<CS_LOG_N, false>(pl, p, batch, stream));
}
