// pbs_prologue: a small batch's keyswitch, modulus switch and first
// accumulator, in one launch, ready for the latency blind rotate.
//
// Replaces no TPU kernel.  The JAX package's keyswitch is XLA's int8
// matmul (concrete_tpu/core/kernels.py:435 keyswitch), its modulus switch
// and LUT rotation plain XLA.  It was added because at B <= 4 the port ran
// that prologue as about 140 small PyTorch launches whose host dispatch,
// not the card, held back the blind rotate: the torch composition in
// core/kernels.py (keyswitch, _switch_and_init, the transpose), which
// ops/prologue.py keeps as this kernel's plain version.
//
// For each ciphertext b of B (1 <= B <= 4), with C = n_out + 1 columns:
//
//   s[c]      = sum_{i < n_in, j < l} d_j(a_i) * K[i][j][c]      (mod 2^64)
//   v[c]      = (c == n_out ? body + offset : 0) - s[c]         (mod 2^64)
//   m[c]      = modulus switch of v[c] to [0, 2N), round half up
//   a_t[b][c] = m[c] for c < n_out;  b~ = m[n_out]
//   acc[r][b] = 0 for r < k;  acc[k][b] = X^{-b~} * LUT_b  (mod X^N + 1)
//
// d_j are the balanced gadget digits of core/kernels.py `decompose`; where
// l * base_log <= 31 its `decompose_hi32` gives the same digits (the hi32
// form is that rounding on the top word alone), so one form serves both.
// K[i][j][c] is the packed key's u64 word, rebuilt from its 8 balanced
// int8 limbs x = sum_s limb_s 2^(8 s): read as one little-endian u64 the
// limbs' bytes give sum_s byte_s 2^(8 s), and each negative limb's byte is
// 2^8 too large, so x = raw - ((raw & 0x80..80) << 1) (mod 2^64).  The
// torch path sums the same products as int32 limb planes and recombines
// them; both are the exact sum mod 2^64 (its int32 planes stay below 2^31
// at K * a_limbs * 2^14 < 2^31, every keyset the port compiles).
//
// Bound: bytes.  The key's K * C * 8 bytes (K = n_in * l rows) are read
// once: 45,809,664 B at tlu4's keyset (n_in 1024, l 8, C 699), 0.0137 ms at
// 3.35 TB/s; the B * K * C 64-bit multiply-adds are small beside them.
// Design: a block is 8 warps on a tile of 32 columns and a chunk of rows,
// each lane one column, each warp every 8th row of the chunk, 8 rows in
// flight (256 B a warp a row, 64 KB a block).  The digits of the chunk's
// rows are computed once into shared memory.  Each block sums its warps'
// partial sums in shared memory and adds them into a u64 scratch with
// 64-bit atomics: addition mod 2^64 is associative, so the bits do not
// depend on the order.  The grid is about four blocks an SM.  A ticket
// counter, behind a fence, tells the last block to finish: it switches,
// writes a_t and the accumulator's body row, and leaves the scratch and
// the counter zeroed for the next launch on the stream.  Every block first
// writes its share of the accumulator's k zero rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;                // columns a block
constexpr int UNROLL = 8;               // rows in flight a warp
constexpr int TARGET_BLOCKS = 4 * 132;  // about four blocks an SM
// the chunk's digits, beside the static 8 KB of partial sums at B = 4
constexpr int MAX_DIGIT_BYTES = 24 * 1024;
constexpr unsigned long long SIGN_BYTES = 0x8080808080808080ull;

// Digit j (1-based) of v: w_j - (w_{j-1} << base_log) on its low 32 bits,
// w_j = round_half_up(v / 2^(64 - j base_log)) (core/kernels.py decompose).
__device__ __forceinline__ long long gadget_digit(unsigned long long v,
                                                  int j, int base_log) {
  const int s = 64 - j * base_log - 1;
  const unsigned long long w = ((v >> s) + 1) >> 1;
  const unsigned long long w_prev = ((v >> (s + base_log)) + 1) >> 1;
  return (long long)(int)(unsigned)(w - (w_prev << base_log));
}

template <int B>
__global__ void __launch_bounds__(THREADS) pbs_prologue_kernel(
    const unsigned long long* __restrict__ ct,
    const unsigned long long* __restrict__ key,
    const unsigned long long* __restrict__ lut, long long lut_stride,
    int* __restrict__ a_t, unsigned long long* __restrict__ acc,
    unsigned long long* __restrict__ scratch, int n_in, int levels,
    int base_log, int cols, int rows_per_block, int kp1, int n, int log_n,
    unsigned long long offset) {
  extern __shared__ long long s_digit[];        // [row][b]
  __shared__ unsigned long long s_part[WARPS][B][TILE];
  __shared__ int s_bt[B];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_rows = n_in * levels;
  const int r0 = blockIdx.y * rows_per_block;
  const int rows = min(rows_per_block, k_rows - r0);
  const int c = blockIdx.x * TILE + lane;
  const int ct_words = n_in + 1;

  // the accumulator's mask rows, (k, B, N) words at its start, are zero
  const long long zeros = (long long)(kp1 - 1) * B * n;
  const long long grid_threads = (long long)gridDim.x * gridDim.y * THREADS;
  for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x)
                     * THREADS + tid;
       i < zeros; i += grid_threads)
    acc[i] = 0;

  for (int i = tid; i < rows * B; i += THREADS) {
    const int r = r0 + i / B, b = i % B;
    s_digit[i] = gadget_digit(ct[(size_t)b * ct_words + r / levels],
                              r % levels + 1, base_log);
  }
  __syncthreads();

  unsigned long long sum[B];
#pragma unroll
  for (int b = 0; b < B; ++b) sum[b] = 0;
  if (c < cols) {
    const unsigned long long* kp = key + (size_t)r0 * cols + c;
    int r = warp;
    for (; r + (UNROLL - 1) * WARPS < rows; r += UNROLL * WARPS) {
      unsigned long long raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        raw[u] = __ldg(kp + (size_t)(r + u * WARPS) * cols);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const unsigned long long w = raw[u] - ((raw[u] & SIGN_BYTES) << 1);
        const long long* d = s_digit + (r + u * WARPS) * B;
#pragma unroll
        for (int b = 0; b < B; ++b) sum[b] += (unsigned long long)d[b] * w;
      }
    }
    for (; r < rows; r += WARPS) {
      const unsigned long long raw = __ldg(kp + (size_t)r * cols);
      const unsigned long long w = raw - ((raw & SIGN_BYTES) << 1);
#pragma unroll
      for (int b = 0; b < B; ++b)
        sum[b] += (unsigned long long)s_digit[r * B + b] * w;
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) s_part[warp][b][lane] = sum[b];
  __syncthreads();
  if (warp == 0 && c < cols) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      unsigned long long t = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += s_part[w][b][lane];
      atomicAdd(scratch + 1 + (size_t)b * cols + c, t);
    }
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned long long blocks =
        (unsigned long long)gridDim.x * gridDim.y;
    s_last = atomicAdd(scratch, 1ull) == blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: the body, the modulus switch, a_t and b~
  const int n_out = cols - 1;
  const int shift = 64 - log_n - 2;
  const unsigned mask = 2u * n - 1;
  for (int i = tid; i < B * cols; i += THREADS) {
    const int b = i / cols, cc = i - b * cols;
    unsigned long long* p = scratch + 1 + i;
    const unsigned long long s = __ldcg(p);
    *p = 0;
    unsigned long long v =
        (cc == n_out ? ct[(size_t)b * ct_words + n_in] + offset : 0ull) - s;
    v >>= shift;
    const int m = (int)(((v + (v & 1)) >> 1) & mask);
    if (cc < n_out)
      a_t[(size_t)b * n_out + cc] = m;
    else
      s_bt[b] = m;
  }
  __syncthreads();
  // the body row: X^{-b~} * LUT_b, a negacyclic rotation by r = 2N - b~
  unsigned long long* body = acc + zeros;
  for (int i = tid; i < B * n; i += THREADS) {
    const int b = i / n, t = i - b * n;
    const int r = (2 * n - s_bt[b]) % (2 * n);
    int src = t - r;
    if (src < 0) src += 2 * n;
    const bool neg = src >= n;
    const unsigned long long x = lut[b * lut_stride + (neg ? src - n : src)];
    body[i] = neg ? 0ull - x : x;
  }
  if (tid == 0) scratch[0] = 0;
}

template <int B>
int launch(const void* ct, const void* key, const void* lut,
           long long lut_stride, void* a_t, void* acc, void* scratch,
           int n_in, int levels, int base_log, int cols, int kp1, int n,
           int log_n, long long offset, cudaStream_t stream) {
  const int k_rows = n_in * levels;
  const int tiles = (cols + TILE - 1) / TILE;
  int chunks = (TARGET_BLOCKS + tiles - 1) / tiles;
  const int most = MAX_DIGIT_BYTES / (B * 8);
  int rows = (k_rows + chunks - 1) / chunks;
  rows = (rows + WARPS - 1) / WARPS * WARPS;
  if (rows > most) rows = most / WARPS * WARPS;
  chunks = (k_rows + rows - 1) / rows;
  const dim3 grid(tiles, chunks);
  pbs_prologue_kernel<B><<<grid, THREADS, rows * B * 8, stream>>>(
      (const unsigned long long*)ct, (const unsigned long long*)key,
      (const unsigned long long*)lut, lut_stride, (int*)a_t,
      (unsigned long long*)acc, (unsigned long long*)scratch, n_in, levels,
      base_log, cols, rows, kp1, n, log_n, (unsigned long long)offset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pbs_prologue(const void* ct, const void* key, const void* lut,
                            long long lut_stride, void* a_t, void* acc,
                            void* scratch, int batch, int n_in, int levels,
                            int base_log, int cols, int kp1, int n,
                            int log_n, long long offset, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
#define PBS_PROLOGUE_CASE(B)                                               \
  case B:                                                                  \
    return launch<B>(ct, key, lut, lut_stride, a_t, acc, scratch, n_in,    \
                     levels, base_log, cols, kp1, n, log_n, offset, s);
  switch (batch) {
    PBS_PROLOGUE_CASE(1)
    PBS_PROLOGUE_CASE(2)
    PBS_PROLOGUE_CASE(3)
    PBS_PROLOGUE_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PBS_PROLOGUE_CASE
}
