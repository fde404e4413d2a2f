// blind_rotate_latency: every step of the latency blind rotate (B <= 4
// ciphertexts, a banded key) in one launch.
//
// Replaces, at the B <= 4 shapes ops/latency.py's plan() takes, the TPU
// kernels concrete_tpu/ops/pallas_step.py rotate_decompose_digits (:322)
// and recombine_accumulate (:385) and runs concrete_tpu/ops/
// pallas_banded_mm.py banded_matmul_fused (:88) in its body: the JAX
// package's _blind_rotate_xla_latency (concrete_tpu/core/kernels.py:
// 710-770) scans n_small steps of
//
//   digits = Decomp(X^{a_i} acc - acc)                 (kernel 1)
//   planes = the negacyclic product of the step's kept key limb rows with
//            the band built from the digits             (kernel 9, latency)
//   acc   += sum_p planes[p] << 8 (p + limb_offset)     (the recombine)
//
// and this kernel computes the same bits.  acc is (k+1, B, N) u64, rows in
// (r, b) order; the key is the packed BSK (n_small, Cin, k+1, S, 2N-1)
// int8, whose raw rows w_vv[..., N-1:] are read in place; a_t (B, n_small)
// int32 is the switched mask.
//
// Bound: latency.  At B=1, k+1 = 2, l = 4, N=1024, 4 kept key limbs and 1
// digit limb a step does 6.7e7 int8 MACs (0.07 us at the int8 peak) and
// must read 64 KB of key (0.02 us at 3.35 TB/s); the three-kernel loop
// took 14.5 us of device time per step (kernel 1 3.3, kernel 9 8.8, the
// recombine 2.4), nearly all of it launch, a round trip to memory and a
// barrier per kernel, and about 70 us of host time.  Design (each part
// timed by tools/ablate_kernels.py; PERF.md has the readings):
//  - one thread-block cluster per ciphertext (B clusters), whose blocks
//    are co-scheduled, so a barrier inside it cannot deadlock where a
//    grid-wide one could; up to 16 blocks (the non-portable most) split
//    the N output coefficients t, 64 each at N=1024 (one 64-t group of 4
//    m16 tiles), 128 at N=2048 (two groups in turn).  A split over t needs
//    no reduction between blocks; the K split of kernel 9's standalone
//    form would need a DSMEM reduction and a second cluster barrier per
//    step;
//  - each block keeps its t slice of the accumulator in shared memory,
//    double-buffered: step i copies buffer i&1 of every block in through
//    distributed shared memory (16-byte loads) and writes its own buffer
//    (i+1)&1, so one barrier.cluster arrive.release / wait.acquire per
//    step orders every read and write, with no round trip to L2;
//  - each block recomputes the digits of the whole (k+1) x N accumulator
//    into shared memory (kernel 1's arithmetic, with 32-bit index math:
//    its t slice needs every digit), then builds kernel 9's band views for
//    its t slice from them (banded_latency.cuh's band_word), the views at
//    a stride of 8 or 24 modulo 32 words so that the A-fragment loads of a
//    warp fall in distinct banks;
//  - the product is kernel 9's fragment build and mma.sync m16n8k32
//    (banded_latency.cuh) on another schedule, since shared-memory loads
//    set its time: 16 warps each take a sixteenth of the K steps for all 4
//    t-tiles of a 64-t group, so one B fragment feeds 4 MMAs (4
//    independent chains), and tile q at k-step ks reads the band words of
//    tile q-2 at ks-1 (the band is Toeplitz in t - j), so only 2 of the 4
//    tiles load A fragments within a K slice; the warps' partials meet in
//    8 shared-memory slots (two rounds) and are summed into the int32
//    planes in C-fragment order, and the recombine's shift-add is the
//    epilogue;
//  - the key does not depend on the accumulator: a 17th warp stages the
//    key rows of a step (64 KB at the latency shape, 80 KB at GameOfLife's
//    N=2048 with 5 key limbs) into a ring by bulk copies (TMA, one a row,
//    counted on the slot's full mbarrier), into a slot once the 16
//    computing warps have arrived on its empty mbarrier (the copies of a
//    step keep the issuing warp 4,000-5,000 clocks, which a computing warp
//    could not hide).  The ring holds two whole steps where they fit: step
//    i+1's rows land while step i computes.  Else it holds one, refilled
//    with step i+1's rows once step i's product has read it: the copy then
//    overlaps step i's recombine, the cluster barrier and step i+1's
//    accumulator copy, digits and band build.  The warp arrives on each
//    step's cluster barrier before it waits for a slot, so its copies
//    never hold the cluster's next step back.
// Shared memory per block: the digits (Cin N 4 bytes; the int32 planes and
// the warps' slots reuse them once the bands are built), the accumulator
// slice's two buffers, the bands of every K slice (the accumulator's copy
// before them), the key ring (two slots or one) and its 4 mbarriers;
// ops/latency.py's plan() computes the same sum and takes a shape only
// where it fits.  The ABLATE_* switches and PHASE_CLOCKS are set only by
// the variant builds of tools/ablate_kernels.py and chip_smoke.py: each
// leaves one part of the work out, to time it, or counts the
// clocks of each part.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "banded_latency.cuh"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr size_t MAX_SMEM = 227 * 1024;   // per block, dynamic
constexpr int MAX_CLUSTER = 16;           // non-portable cluster size
constexpr int KCHUNKS = 16;               // computing warps, one K chunk each
constexpr int BR_THREADS = 32 * KCHUNKS;
constexpr int SLOTS = KCHUNKS / 2;        // slots the partials meet in
constexpr int BLOCK = BR_THREADS + 32;    // and the key rows' producer
constexpr int TILES = LT / 16;            // m16 tiles of a 64-t group
constexpr int FRAG = TILES * 4 * 32;      // C fragment words of a warp

struct BrShape {
  LatShape sh;            // one step's product; lhs: step 0's raw rows
  const int32_t* a_t;     // (B, n_small)
  unsigned long long* acc;  // (k+1, B, N), updated in place
  long long step_bytes;   // bytes of one key step
  int n_small, kp1, batch, levels, base_log, limb_offset;
  int ltb, lg_ltb;        // output coefficients t per block, its log2
  int passes;             // 64-t groups x digit limbs x n tiles
  int band_need;          // words of a band view the MMA reads
  int region;             // bytes of the digits / planes region
  int bands;              // bytes of the bands (or accumulator copy)
  int ring_slot;          // bytes of one step's staged key rows
  int slots;              // ring slots: 2, or 1 where two do not fit
};

using banded::mbar_arrive;
using banded::mbar_init;
using banded::mbar_wait;
using tma::bulk_copy;
using tma::cluster_arrive;
using tma::cluster_barrier;
using tma::cluster_wait;
using tma::mbar_arrive_tx;

// A barrier of the 16 computing warps (the producer warp not in it).
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(BR_THREADS) : "memory");
}

#ifdef PHASE_CLOCKS
// (tools/ablate_kernels.py's instrumented build: thread 0 of block 0 of
// the first cluster adds the clocks from one point of the step to the
// next into these, read by blind_rotate_latency_phases)
__device__ unsigned long long g_phase[8];
#define PHASE(k)                                                          \
  do {                                                                    \
    if (tid == 0 && rank == 0 && b == 0) {                                \
      const long long now = clock64();                                    \
      g_phase[k] += now - t_last;                                         \
      t_last = now;                                                       \
    }                                                                     \
  } while (0)
#else
#define PHASE(k)
#endif

// Block (rank, 0, b): outputs t in [rank * ltb, (rank + 1) * ltb) of
// ciphertext b for every step.
__global__ void __launch_bounds__(BLOCK) blind_rotate_latency_kernel(
    BrShape p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), b = blockIdx.z;
  const int tb = rank * p.ltb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  LatShape sh = p.sh;
  const int n = sh.n, kp1 = p.kp1, ltb = p.ltb;
  int32_t* dig = reinterpret_cast<int32_t*>(smem);  // [Cin][N]
  // the int32 planes [passes][FRAG], then the K chunks' slots
  // [SLOTS][FRAG]
  int* red = reinterpret_cast<int*>(smem);
  int* slots = red + p.passes * FRAG;
  // this block's slice of the accumulator, two buffers [2][k+1][ltb]
  unsigned long long* mine =
      reinterpret_cast<unsigned long long*>(smem + p.region);
  unsigned char* bands = smem + p.region + 2 * (size_t)kp1 * ltb * 8;
  unsigned char* ring = bands + p.bands;
  sh.digits = dig;
  const int kps = sh.js / 32;                       // k-steps per slice
  const int ksteps = sh.slices * kps;
  // warp kc: K chunk kc, every t-tile
  const int kc = warp;
  const int per_chunk = (ksteps + KCHUNKS - 1) / KCHUNKS;
  const int k_lo = min(kc * per_chunk, ksteps);
  const int k_hi = min(k_lo + per_chunk, ksteps);

  // step i's key rows into ring slot i mod slots: one bulk copy (TMA) a
  // row, from the 16-byte boundary at or below its start, counted in bytes
  // on the slot's full barrier (the wrapper makes sure a row may be read
  // 16 bytes past the key's end); issued by a warp of its own, since a
  // step's 64-80 copies keep the issuing warp 4,000-5,000 clocks: it
  // refills a slot once the 16 computing warps have arrived on its empty
  // barrier.  Step i's slot, and the parity of its barriers' phase (the
  // slot's (i / slots)-th use), with slots 1 or 2:
  const int lg_slots = p.slots - 1;
  auto slot_of = [&](int i) { return i & lg_slots; };
  auto parity_of = [&](int i) { return (i >> lg_slots) & 1; };
  const int nrows = sh.slices * sh.ncols;
  const uint32_t full = smem_addr(ring + (size_t)p.slots * p.ring_slot);
  const uint32_t empty = full + 16;
  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, KCHUNKS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == KCHUNKS) {
    auto stage_key = [&](int i) {
      const uint32_t bar = full + 8 * slot_of(i);
#ifdef ABLATE_NO_KEY
      if (lane == 0) mbar_arrive(bar);  // (no key rows: times the rest)
      return;
#endif
      if (lane == 0) mbar_arrive_tx(bar, (uint32_t)(nrows * sh.lhs_row));
      __syncwarp();
      LatShape ks = sh;
      ks.lhs = sh.lhs + (long long)i * p.step_bytes;
      const uint32_t slot =
          smem_addr(ring + (size_t)slot_of(i) * p.ring_slot);
      for (int row = lane; row < nrows; row += 32) {
        const int sl = row / sh.ncols, c = row - sl * sh.ncols;
        const int ci = sl / sh.jblocks, jb = sl - ci * sh.jblocks;
        const int8_t* base = (const int8_t*)(
            (uintptr_t)lhs_row(ks, c, ci, jb) & ~(uintptr_t)15);
        bulk_copy(slot + row * sh.lhs_row, base, sh.lhs_row, bar);
      }
    };
    // step 0 (and, with two slots, step 1) at once; then, during step i,
    // step j = i + 1's into the slot that step j - slots has left: with
    // one slot, once step i's product has read it (no prefetch: step i's,
    // during step i)
    stage_key(0);
#ifndef ABLATE_NO_PREFETCH
    if (p.slots == 2 && p.n_small > 1) stage_key(1);
    const int ahead = 1, first = p.slots;
#else
    const int ahead = 0, first = 1;
#endif
    cluster_barrier();                  // the computing warps' first one
    for (int i = 0; i < p.n_small; ++i) {
      // step i's cluster barrier: this warp writes nothing another block
      // reads, so it arrives at once and waits for the others last
      cluster_arrive();
      const int j = i + ahead;
      if (j >= first && j < p.n_small) {
        if (j >= p.slots)
          mbar_wait(empty + 8 * slot_of(j), parity_of(j - p.slots));
        stage_key(j);
      }
      __syncwarp();
      cluster_wait();
    }
    return;
  }

  // the first accumulator's slice, then every block's is in
  for (int e = tid; e < kp1 * ltb; e += BR_THREADS) {
    const int r = e / ltb, tl = e - r * ltb;
    mine[e] = p.acc[((size_t)r * p.batch + b) * n + tb + tl];
  }
  cluster_barrier();
#ifdef PHASE_CLOCKS
  long long t_last = clock64();
#endif

  const int two_n = 2 * n, quads = n / 4;
  const int n_out = sh.a_limbs + sh.s_planes - 1;
  const int used = min(8 - p.limb_offset, n_out);
  // this thread's A fragments start at band row y0 of tile 0 (tile q at
  // y0 + 16 q, one view: y0 mod 4 is the same for every tile)
  const int y0 = g - 4 * tg + sh.js - 3;
  int a_next = p.a_t[(size_t)b * p.n_small];
  for (int i = 0; i < p.n_small; ++i) {
#ifndef ABLATE_NO_DIGITS
    const int a_step = a_next;           // the next step's, loaded early
    if (i + 1 < p.n_small) a_next = p.a_t[(size_t)b * p.n_small + i + 1];
#endif
    const unsigned long long* cur = mine + (size_t)(i & 1) * kp1 * ltb;
    unsigned long long* nxt = mine + (size_t)((i + 1) & 1) * kp1 * ltb;

    // 1. the digits of X^a acc - acc, every row r and level: every
    //    block's slice of the accumulator copied in (16-byte loads of
    //    distributed shared memory, into the bands' space, free until step
    //    2), then kernel 1's arithmetic, dig[lev (k+1) + r][t]
#ifndef ABLATE_NO_DIGITS
    unsigned long long* whole =
        reinterpret_cast<unsigned long long*>(bands);   // [k+1][N]
#pragma unroll 4
    for (int e = tid; e < kp1 * n / 2; e += BR_THREADS) {
      const int r = e / (n / 2), t = (e - r * (n / 2)) * 2;
      const ulonglong2* src = reinterpret_cast<const ulonglong2*>(
          cluster.map_shared_rank(cur + r * ltb + (t & (ltb - 1)),
                                  t >> p.lg_ltb));
      *reinterpret_cast<ulonglong2*>(whole + (size_t)r * n + t) = *src;
    }
    int a = a_step % two_n;
    if (a < 0) a += two_n;
    compute_sync();
    PHASE(1);
    for (int q = tid; q < kp1 * quads; q += BR_THREADS) {
      const int r = q / quads, t0 = (q - r * quads) * 4;
      const unsigned long long* row = whole + (size_t)r * n;
      uint64_t v[4], w_prev[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + k;
        int s = t - a;
        if (s < 0) s += two_n;
        const uint64_t x = s >= n ? (uint64_t)0 - row[s - n] : row[s];
        v[k] = x - row[t];
        w_prev[k] = ((v[k] >> 63) + 1) >> 1;
      }
      for (int lev = 0; lev < p.levels; ++lev) {
        const int shift = 63 - (lev + 1) * p.base_log;
        int4 d;
        int* dk = &d.x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t w = ((v[k] >> shift) + 1) >> 1;
          dk[k] = (int32_t)(uint32_t)(w - (w_prev[k] << p.base_log));
          w_prev[k] = w;
        }
        *reinterpret_cast<int4*>(dig + (size_t)(lev * kp1 + r) * n + t0) = d;
      }
    }
#endif
    compute_sync();
    PHASE(2);

    // 2. the band views of every K slice for this block's t slice, the
    //    slices' words shared out over all the threads at once
    for (int it = tid; it < sh.slices * p.band_need; it += BR_THREADS) {
      const int sl = it / p.band_need, w = it - sl * p.band_need;
      const int ci = sl / sh.jblocks, jb = sl - ci * sh.jblocks;
      band_word<true, true>(sh, reinterpret_cast<uint32_t*>(
                              bands + (size_t)sl * sh.band_bytes),
                      ci, 0, tb - jb * sh.js - sh.js, w);
    }
    PHASE(0);
    mbar_wait(full + 8 * slot_of(i), parity_of(i));  // step i's key rows
    compute_sync();
    PHASE(3);
    // 3. the product: warp kc takes k-steps [k_lo, k_hi) of the slices
    //    laid end to end, for all 4 t-tiles of each 64-t group at once, so
    //    one B fragment feeds 4 MMAs (4 independent chains); tile q at
    //    k-step ks reads the band words of tile q - 2 at ks - 1 (the band
    //    is Toeplitz: t - j is the same), so only tiles 0 and 1 load
    //    theirs within a K slice.  Per pass (64-t group, digit limb, n
    //    tile) the K chunks' partials meet in their slots (over the
    //    digits, now dead) and are summed into the int32 planes in
    //    C-fragment order: red[pass][(q 4 + e) 32 + lane] for tile q
    const unsigned char* slot = ring + (size_t)slot_of(i) * p.ring_slot;
    LatShape si = sh;
    si.lhs = sh.lhs + (long long)i * p.step_bytes;
    int pass = 0;
    for (int t0 = 0; t0 < ltb; t0 += LT) {
      const int w0 = (y0 + t0) >> 2;     // tile 0's word at k-step 0
      for (int s = 0; s < sh.s_planes; ++s) {
        for (int nt = 0; nt < sh.ntiles; ++nt, ++pass) {
          const int c = nt * 8 + g;
          const bool live = c < sh.ncols;
          int acc[TILES][4] = {};
#ifndef ABLATE_NO_MMA
          for (int kg = k_lo; kg < k_hi;) {
            const int sl = kg / kps, ks0 = kg - sl * kps;
            const int ks1 = min(kps, ks0 + (k_hi - kg));
            const int ci = sl / sh.jblocks, jb = sl - ci * sh.jblocks;
            const uint32_t* band = reinterpret_cast<const uint32_t*>(
                                       bands + (size_t)sl * sh.band_bytes) +
                                   (4 * s + (y0 & 3)) * sh.band_words;
            const int m =
                live ? (int)((uintptr_t)lhs_row(si, c, ci, jb) & 15) : 0;
            const uint32_t* lrow = reinterpret_cast<const uint32_t*>(
                slot + (size_t)sl * sh.slice_bytes +
                (live ? c : 0) * sh.lhs_row);
            const int o0 = m + 4 * tg, bsh = 8 * (o0 & 3);
            // tiles 0, 1 "at ks0 - 1": tiles 2, 3 at ks0
            uint32_t af[TILES][4];
#pragma unroll
            for (int q = 0; q < 2; ++q)
              load_a(af[q], band, w0 + 4 * (q + 2) - 8 * ks0);
#pragma unroll 4
            for (int ks = ks0; ks < ks1; ++ks) {
#pragma unroll
              for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) af[q + 2][e] = af[q][e];
#pragma unroll
              for (int q = 0; q < 2; ++q)
                load_a(af[q], band, w0 + 4 * q - 8 * ks);
              uint32_t b0f, b1f;
              load_b(b0f, b1f, lrow, o0, bsh, ks);
              if (!live) b0f = b1f = 0;
#pragma unroll
              for (int q = 0; q < TILES; ++q)
                mma_s8(acc[q], af[q], b0f, b1f);
            }
            kg += ks1 - ks0;
          }
#endif
          // this warp's C fragments (rows g, g+8 of each tile, columns
          // 2tg, 2tg+1 of the n tile): chunks SLOTS.. into the slots,
          // chunks 0.. add theirs there, then the slots summed
          int* mine_slot = slots + (kc % SLOTS) * FRAG + lane;
          if (kc >= SLOTS) {
#pragma unroll
            for (int q = 0; q < TILES; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                mine_slot[(q * 4 + e) * 32] = acc[q][e];
          }
          compute_sync();
          PHASE(4);
          if (kc < SLOTS) {
#pragma unroll
            for (int q = 0; q < TILES; ++q)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                int& cell = mine_slot[(q * 4 + e) * 32];
                cell = (int)((uint32_t)cell + (uint32_t)acc[q][e]);
              }
          }
          compute_sync();
          for (int j = tid; j < FRAG; j += BR_THREADS) {
            uint32_t sum = 0;
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
              sum += (uint32_t)slots[k * FRAG + j];
            red[pass * FRAG + j] = (int)sum;
          }
          compute_sync();                // the slots free again
          PHASE(5);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * slot_of(i));   // step i's read
    PHASE(6);

    // 4. the recombine: acc[r, b, t] += sum_p plane_p << 8 (p + offset),
    //    plane p the int32 sum over the limb pairs a + s = p, each read
    //    where its C fragment put it
    for (int e = tid; e < kp1 * ltb; e += BR_THREADS) {
      const int r = e / ltb, tl = e - r * ltb;
      const int tq = tl & (LT - 1), q = tq >> 4, row = tq & 15;
      const int base = (tl / LT) * sh.s_planes;
      unsigned long long add = 0;
      for (int pl = 0; pl < used; ++pl) {
        uint32_t sum = 0;
        for (int s = 0; s < sh.s_planes; ++s) {
          const int al = pl - s;
          if (al < 0 || al >= sh.a_limbs) continue;
          const int col = r * sh.a_limbs + al, cc = col & 7;
          const int fe = 2 * (row >> 3) + (cc & 1);
          const int fl = (row & 7) * 4 + (cc >> 1);
          sum += (uint32_t)red[((base + s) * sh.ntiles + (col >> 3)) * FRAG +
                               (q * 4 + fe) * 32 + fl];
        }
        add += (unsigned long long)(long long)(int32_t)sum
               << (8 * (pl + p.limb_offset));
      }
      nxt[e] = cur[e] + add;
    }
    cluster_barrier();                   // every block's next slice in
    PHASE(7);
  }
  const unsigned long long* last = mine + (size_t)(p.n_small & 1) * kp1 * ltb;
  for (int e = tid; e < kp1 * ltb; e += BR_THREADS) {
    const int r = e / ltb, tl = e - r * ltb;
    p.acc[((size_t)r * p.batch + b) * n + tb + tl] = last[e];
  }
}

// The plan: ops/latency.py plan() computes the same numbers.
struct Plan {
  LatShape sh;
  int ltb, lg_ltb, passes, band_need, region, bands, ring_slot, slots;
  size_t smem;
};

bool make_plan(Plan& pl, int kp1, int levels, int d_limbs, int s_key, int n,
               int cluster) {
  if (n % LT || cluster < 1 || cluster > MAX_CLUSTER || n % cluster)
    return false;
  pl.ltb = n / cluster;
  if (pl.ltb % LT || (pl.ltb & (pl.ltb - 1))) return false;
  pl.lg_ltb = 0;
  while ((1 << pl.lg_ltb) < pl.ltb) ++pl.lg_ltb;
  LatShape& sh = pl.sh;
  sh.a_limbs = s_key;
  sh.rows = kp1;
  sh.cin = levels * kp1;
  sh.kp1 = sh.cin;             // the lhs addressing: one level of Cin rows
  sh.batch = 1;                // the digits in shared memory: one ciphertext
  sh.s_planes = d_limbs;
  sh.n = n;
  sh.js = JS_MAX;              // the largest divisor of N ...
  while (n % sh.js) sh.js /= 2;   // ... down to LT
  sh.jblocks = n / sh.js;
  sh.slices = sh.cin * sh.jblocks;
  sh.cl = cluster;
  sh.ncols = kp1 * s_key;
  sh.ntiles = (sh.ncols + 7) / 8;
  // the words of a view the MMA reads, and the views' stride: 8 or 24
  // modulo 32 words, so that a warp's A-fragment loads from the 4 views
  // fall in distinct banks
  pl.band_need = (sh.js + pl.ltb) / 4 + 1;
  sh.band_words = pl.band_need;
  while (sh.band_words % 16 != 8) ++sh.band_words;
  sh.band_bytes = (4 * d_limbs * sh.band_words * 4 + 15) / 16 * 16;
  sh.lhs_row = sh.js + 16;
  sh.slice_bytes = sh.ncols * sh.lhs_row;
  const size_t dig = (size_t)sh.cin * n * 4;
  pl.passes = pl.ltb / LT * d_limbs * sh.ntiles;
  const size_t red = (size_t)(pl.passes + SLOTS) * FRAG * 4;
  pl.region = (int)(((dig > red ? dig : red) + 15) / 16 * 16);
  pl.ring_slot = sh.slices * sh.slice_bytes;
  const size_t bands = (size_t)sh.slices * sh.band_bytes;
  const size_t whole = (size_t)kp1 * n * 8;
  pl.bands = (int)(bands > whole ? bands : whole);
  const size_t fixed = (size_t)pl.region + 2 * (size_t)kp1 * pl.ltb * 8 +
                       pl.bands + 32;           // + the ring's mbarriers
  pl.slots = fixed + 2 * (size_t)pl.ring_slot <= MAX_SMEM ? 2 : 1;
  pl.smem = fixed + pl.slots * (size_t)pl.ring_slot;
  return pl.smem <= MAX_SMEM;
}

}  // namespace

// a_t (B, n_small) int32; acc (k+1, B, N) u64, the first accumulator,
// overwritten by the last; planes (n_small, Cin, k+1, S, 2N-1) int8,
// 16-byte aligned, ending at planes_end.
extern "C" int blind_rotate_latency(
    const void* a_t, void* acc, const void* planes, const void* planes_end,
    int batch, int n_small, int kp1, int levels, int base_log, int d_limbs,
    int s_key, int n, int limb_offset, int cluster, void* stream) {
  Plan pl{};
  if (batch < 1 || batch > 65535 || n_small < 1 || kp1 < 1 || levels < 1 ||
      levels * base_log > 63 || d_limbs < 1 || d_limbs > 4 || s_key < 1 ||
      s_key > 8 || limb_offset < 0 || limb_offset > 7 ||
      (uintptr_t)planes % 16 ||
      !make_plan(pl, kp1, levels, d_limbs, s_key, n, cluster))
    return (int)cudaErrorInvalidValue;
  BrShape p{};
  p.sh = pl.sh;
  const long long vlen = 2LL * n - 1;
  p.sh.lhs = (const int8_t*)planes + (n - 1);
  p.sh.lhs_end = (const int8_t*)planes_end;
  // lhs[a, r, ci, j] = w_vv[ci, r, a, N-1 + j]: ci one level of Cin rows
  p.sh.st_a = vlen;
  p.sh.st_r = s_key * vlen;
  p.sh.st_lev = 0;
  p.sh.st_rin = kp1 * s_key * vlen;
  p.a_t = (const int32_t*)a_t;
  p.acc = (unsigned long long*)acc;
  p.step_bytes = (long long)p.sh.cin * kp1 * s_key * vlen;
  p.n_small = n_small;
  p.kp1 = kp1;
  p.batch = batch;
  p.levels = levels;
  p.base_log = base_log;
  p.limb_offset = limb_offset;
  p.ltb = pl.ltb;
  p.lg_ltb = pl.lg_ltb;
  p.passes = pl.passes;
  p.band_need = pl.band_need;
  p.region = pl.region;
  p.bands = pl.bands;
  p.ring_slot = pl.ring_slot;
  p.slots = pl.slots;

  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_latency_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(blind_rotate_latency_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, batch);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, blind_rotate_latency_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef PHASE_CLOCKS
// The instrumented build's clocks per phase (8), summed over its launches
// since the last call, which zeroes them.
extern "C" int blind_rotate_latency_phases(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
#endif
