// The wgmma main loop of the banded int8 product, shared by kernel B
// (external_product.cu: the product shift-added into the u64 accumulator)
// and kernel 9's table form (banded_mm.cu: the product's int32 planes
// stored).  Both compute, per output plane p,
//
//   d[b, cout, p, t] = sum_{cin, a, j; s = p - a in [0, S)}
//                          lhs[b, cin, a, j] * vv[cin, cout, s, N-1+t-j]
//
// with lhs[b, cin, a, j] = lhs_mem[(lev * A + a) * B * kp1 * N
//                                  + (b * kp1 + r) * N + j], cin = lev*kp1 + r.
// That reads kernel A's digit planes (l*A, B*(k+1), N) in place with kp1 =
// k+1, and the JAX package's stacked lhs (A, B, Cin*N) with kp1 = Cin and
// one level.  vv is (Cin, Cout, S, 2N-1), the negacyclic extension of each
// key limb plane.
//
// wgmma takes s8 shared-memory operands K-major only, and a K-major
// Toeplitz tile would have to be built byte by byte.  So the roles are:
//  - A (registers, M = 64 output coefficients t, K = j): the key band.  An
//    A-fragment register holds 4 consecutive j of one t (the m16n8k32 A
//    layout per warp: rows g and g+8, bytes 4tg..+3 and 16+4tg..+3), which
//    is a funnel shift of two aligned words of the key window staged as it
//    lies in vv (N+80 bytes per (cin, s)), byte-reversed.  A chunk moves y
//    by multiples of 4, so one shift serves a thread's 32 registers and
//    their words sit at constant offsets from one base: the words of one
//    window serve all 64 t of the tile and every ciphertext of it;
//  - B (shared memory, N = 128 ciphertexts, K-major): the lhs rows.  A row
//    is contiguous in j, so 16-byte cp.async pieces land directly in
//    wgmma's 128-byte-swizzle layout: rows of 128 j, 8-row atoms of 1024
//    bytes, chunk c of row r at c ^ (r mod 8); a k-step of 32 j is a
//    32-byte step of the descriptor's start address.  Without the swizzle
//    the 8-row groups, 1024 bytes apart, share banks (11% slower for
//    kernel B: tools/ablate_kernels.py, PERF.md);
//  - one warpgroup per output plane p (up to 4 per block, fewer where their
//    key windows do not fit: 3 at N = 16384, 1 at N = 32768; more planes
//    take more blocks): each keeps its own int32 accumulator (64 registers
//    at N = 128), which the epilogue takes;
//  - a 4-slot cp.async ring of 128 b x 256 j lhs tiles (32 KB), staged
//    two chunks ahead by every thread, the key windows of each (a, cin)
//    with the tile of its first chunk.  Per slot, a "full" mbarrier counts
//    every thread's copies in and an "empty" one every warp's reads out,
//    so no block-wide barrier ties the warpgroups together: one builds its
//    fragments while another's wgmma runs.
// int32 plane sums cannot overflow (A*Cin*N*128*128 = 1.3e8 at N=1024), and
// no .satfinite is asked for.  The ABLATE_* switches below are set only by
// tools/ablate_kernels.py's variant builds: each leaves one part of the work
// out (or changes the layout, same function) to time it.
//
// An epilogue is a struct with
//   __device__ bool live(int p) const;      // is plane p computed
//   static size_t smem(int n_wg);           // shared memory it reuses
//   __device__ void operator()(const Shape&, unsigned char* smem,
//       int (&d)[64], bool live, int t0, int b0, int cout, int p_lo) const;
// and launch_banded_wgmma<Epilogue> launches the kernel with it.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace banded {

constexpr int TM = 64;            // output coefficients per block (wgmma M)
constexpr int BN = 128;           // lhs rows (ciphertexts) per block (wgmma N)
#ifdef ABLATE_JC128
constexpr int JC = 128;           // (one swizzle atom: the same function)
#else
constexpr int JC = 256;           // j per staged lhs tile (2 swizzle atoms)
#endif
constexpr int KSTEPS = JC / 32;   // wgmma k-steps per tile
constexpr int JQ = JC / 16;       // 16-byte pieces per tile row
constexpr int STAGES = 4;         // ring slots
constexpr int PF = STAGES - 2;    // chunks staged ahead of the consumer
constexpr int MAX_WG = 4;         // planes per block, one warpgroup each
constexpr int TILE = BN * JC;     // bytes of one lhs tile
constexpr int WIN_PAD = 80;       // key window bytes beyond N per slot
// dynamic shared memory per block: the H100's 227 KB less the barriers
constexpr size_t MAX_SMEM = 227 * 1024 - 2 * STAGES * 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\n"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile("{\n.reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n}\n"
               :: "r"(bar), "r"(parity) : "memory");
}

// wgmma descriptor of a K-major s8 tile in the 128-byte swizzle: start
// address, leading byte offset unused (1), stride byte offset 1024 between
// 8-row atoms, layout type 1.
__device__ __forceinline__ uint64_t digit_desc(uint32_t saddr) {
#ifdef ABLATE_NO_SWIZZLE
  // no swizzle: core matrices of 8 rows x 16 bytes, j-adjacent ones 128
  // bytes apart, 8-row groups JQ * 128 bytes apart
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(JQ * 128 >> 4) << 32);
#else
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
#endif
}

// Start address of k-step kk (32 j) of a tile: its 128-j atom column, then
// 32 bytes into the atom's rows.
__device__ __forceinline__ uint32_t kstep_addr(uint32_t tile, int kk) {
#ifdef ABLATE_NO_SWIZZLE
  return tile + kk * 256;
#else
  return tile + (kk >> 2) * (BN * 128) + (kk & 3) * 32;
#endif
}

// Byte offset in a tile of the 16-byte piece jq (j = 16 jq ..) of row
// 8 grp + r8.
__device__ __forceinline__ uint32_t piece_dst(int grp, int r8, int jq) {
#ifdef ABLATE_NO_SWIZZLE
  return grp * (JQ * 128) + jq * 128 + r8 * 16;
#else
  return (jq >> 3) * (BN * 128) + grp * 1024 + r8 * 128 +
         (((jq & 7) ^ r8) << 4);
#endif
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Keeps the accumulators in their registers across the asynchronous MMAs.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 4 key bytes w[y..y+3] of a staged window (y = 4q + sh/8), reversed:
// byte i of the result is w[y+3-i], the band at j+i for one output t.
__device__ __forceinline__ uint32_t band_word(uint32_t lo, uint32_t hi,
                                              int sh) {
  return __byte_perm(__funnelshift_r(lo, hi, sh), 0, 0x0123);
}

// The accumulator fragment: register i of thread (wi, g, tg) of a
// warpgroup holds output t0 + frag_t(i, wi, g) of lhs row b0 +
// frag_b(i, tg).
__device__ __forceinline__ int frag_t(int i, int wi, int g) {
  return 16 * wi + g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_b(int i, int tg) {
  return 8 * (i >> 2) + 2 * tg + (i & 1);
}

struct Shape {
  const int8_t* planes;   // the lhs, addressed as the header says
  const int8_t* vv;
  const int8_t* vv_end;
  int batch, a_limbs, kp1, n, s_planes, cin_n, jcn, n_wg;
  int win_slots;        // key-window slots: 2 once a window spans 3+ chunks
  int cout_n;           // key rows per cin (kernel B: k+1)
};

// The coordinates of a chunk c = (a * Cin + cin) * N/JC + jc, stepped in
// order: no division in the loop.
struct Chunk {
  int jc = 0, cin = 0, a = 0, ac = 0;
  __device__ __forceinline__ void next(const Shape& sh) {
    if (++jc == sh.jcn) {
      jc = 0;
      ++ac;
      if (++cin == sh.cin_n) { cin = 0; ++a; }
    }
  }
};

// Byte offset in vv of the key row (cin, cout, s) at coefficient t0.
__device__ __forceinline__ size_t key_row(const Shape& sh, int cin, int cout,
                                          int s, int t0) {
  return ((size_t)(cin * sh.cout_n + cout) * sh.s_planes + s) *
             (2 * (size_t)sh.n - 1) + t0;
}

// Stage chunk c (coordinates k): its lhs tile into ring slot c mod
// STAGES and, at jc = 0, the key windows of (a, cin) for this block's
// planes into window slot ac mod win_slots.
__device__ __forceinline__ void issue_chunk(const Shape& sh, int c,
                                            const Chunk& k,
                                            unsigned char* tiles,
                                            unsigned char* wins, int b0,
                                            int t0, int cout, int p_lo) {
#ifdef ABLATE_NO_STAGING
  return;                        // (leaves work out: times the rest)
#endif
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lev = k.cin / sh.kp1, r = k.cin - lev * sh.kp1;
  const size_t row_bytes = (size_t)sh.kp1 * sh.n;
  const int8_t* src_plane =
      sh.planes + (size_t)(lev * sh.a_limbs + k.a) * sh.batch * row_bytes +
      (size_t)r * sh.n + (size_t)k.jc * JC;
  const uint32_t tile = smem_addr(tiles + (c % STAGES) * TILE);
  // a warp's 32 pieces: 8 rows x 4 consecutive pieces, 64 contiguous bytes
  // of each row, stored to 32 distinct 16-byte slots of the swizzle
  for (int i = tid; i < TILE / 16; i += nthreads) {
    const int l = i & 31, q = i >> 5;
    const int grp = q / (JQ / 4), jq = (l >> 3) + 4 * (q % (JQ / 4));
    const int b = b0 + grp * 8 + (l & 7);
    const uint32_t dst = tile + piece_dst(grp, l & 7, jq);
    if (b < sh.batch)
      cp_async16(dst, src_plane + b * row_bytes + jq * 16, 16);
    else
      cp_async16(dst, sh.planes, 0);           // rows past B: zeros
  }
  if (k.jc != 0) return;
  const int win_len = sh.n + WIN_PAD, words = win_len / 4;
  unsigned char* wdst =
      wins + (size_t)(k.ac % sh.win_slots) * sh.n_wg * win_len;
  for (int sl = 0; sl < sh.n_wg; ++sl) {
    const int s = p_lo + sl - k.a;
    if (s < 0 || s >= sh.s_planes) continue;
    // the window starts at the aligned word holding vv[.., t0] (up to 3
    // bytes before it, inside vv's storage); bytes past vv are not read
    const int8_t* row = sh.vv + key_row(sh, k.cin, cout, s, t0);
    const int8_t* base = (const int8_t*)((uintptr_t)row & ~(uintptr_t)3);
    for (int w = tid; w < words; w += nthreads) {
      const int8_t* src = base + 4 * w;
      const long long left = (long long)(sh.vv_end - src);
      const int nb = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
      cp_async4(smem_addr(wdst + sl * win_len + 4 * w), nb ? src : sh.vv,
                nb);
    }
  }
}

// Block (t0 / TM, b0 / BN, cout + cout_n * plane group): warpgroup wg
// computes plane p_lo + wg into d, through the ring, and hands it to ep.
template <class Epilogue>
__global__ void __launch_bounds__(MAX_WG * 128, 1) banded_wgmma_kernel(
    Shape sh, Epilogue ep) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * STAGES];
  // the swizzle reads address bits 7-9: tiles start on 1024 bytes
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* tiles = smem;                        // [STAGES][TILE]
  unsigned char* wins = smem + STAGES * TILE;  // [win_slots][n_wg][N+80]
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int wi = (tid >> 5) & 3, g = lane >> 2, tg = lane & 3;
  const int t0 = blockIdx.x * TM, b0 = blockIdx.y * BN;
  const int cout = blockIdx.z % sh.cout_n;
  const int p_lo = (blockIdx.z / sh.cout_n) * sh.n_wg;
  const int p = p_lo + wg;                            // this warpgroup's plane
  const bool live = ep.live(p);
  const int chunks = sh.a_limbs * sh.cin_n * sh.jcn;
  const int win_len = sh.n + WIN_PAD;
  const uint32_t full = smem_addr(bars), empty = full + 8 * STAGES;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, blockDim.x);        // every thread's copies
      mbar_init(empty + 8 * i, blockDim.x / 32);  // every warp's reads
    }
  }
  __syncthreads();

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  Chunk in, at;                      // the chunk staged next, the one used
  for (int c = 0; c < PF && c < chunks; ++c) {
    issue_chunk(sh, c, in, tiles, wins, b0, t0, cout, p_lo);
    in.next(sh);
    cp_async_arrive(full + 8 * (c % STAGES));
  }
  uint32_t af[KSTEPS][4];
  for (int c = 0; c < chunks; ++c) {
    // stage chunk c + PF once every warp is done with the slot's last use
    // (the use k of a slot completes its barriers' phase k)
    const int cn = c + PF;
    if (cn < chunks) {
      if (cn >= STAGES)
        mbar_wait(empty + 8 * (cn % STAGES), (cn / STAGES - 1) & 1);
      issue_chunk(sh, cn, in, tiles, wins, b0, t0, cout, p_lo);
      in.next(sh);
      cp_async_arrive(full + 8 * (cn % STAGES));
    }
    const Chunk k = at;
    at.next(sh);
    const int s = p - k.a;
    if (live && s >= 0 && s < sh.s_planes) {            // per warpgroup
      mbar_wait(full + 8 * (c % STAGES), (c / STAGES) & 1);
      // every thread's copies of chunk c are in: make them visible to the
      // async proxy (wgmma's operand reads)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      // band[t][j] = window[m + t - t0 + N-1 - j]; the 4 bytes of j..j+3
      // at t are window[y..y+3] reversed, y = m + (t - t0) + N - 4 - j
      const int8_t* row = sh.vv + key_row(sh, k.cin, cout, s, t0);
      const int y0 = (int)((uintptr_t)row & 3) + 16 * wi + g + sh.n - 4 -
                     4 * tg - k.jc * JC;
      const uint32_t* w = reinterpret_cast<const uint32_t*>(
          wins + ((size_t)(k.ac % sh.win_slots) * sh.n_wg + wg) * win_len) +
          (y0 >> 2) - 4;
      const int shift = 8 * (y0 & 3);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t* wk = w - 8 * kk;
#ifdef ABLATE_NO_FRAGMENTS
        // (leaves the fragment build out: times the rest)
        af[kk][0] = tid + kk; af[kk][1] = (uint32_t)(uintptr_t)wk;
        af[kk][2] = shift + kk; af[kk][3] = c;
#else
        af[kk][2] = band_word(wk[0], wk[1], shift);   // row g,   j + 16
        af[kk][3] = band_word(wk[2], wk[3], shift);   // row g+8, j + 16
        af[kk][0] = band_word(wk[4], wk[5], shift);   // row g,   j
        af[kk][1] = band_word(wk[6], wk[7], shift);   // row g+8, j
#endif
      }
      const uint32_t tile = smem_addr(tiles + (c % STAGES) * TILE);
      fence_acc(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        wgmma_m64n128k32(d, af[kk], digit_desc(kstep_addr(tile, kk)));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(d);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (c % STAGES));
  }
  // chunks no warpgroup used may still be landing
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  ep(sh, smem, d, live, t0, b0, cout, p_lo);
}

// Launches the kernel for `planes_used` output planes (0 launches nothing)
// with as many planes per block as fit: the ring and the key windows, or
// the epilogue's shared memory, and 1024 bytes to align the tiles.
template <class Epilogue>
int launch_banded_wgmma(Shape sh, const Epilogue& ep, int planes_used,
                        cudaStream_t stream) {
  if (planes_used <= 0 || sh.batch <= 0) return (int)cudaSuccess;
  if (sh.n % JC) return (int)cudaErrorInvalidValue;
  // a window slot is rewritten STAGES chunks after its last use began
  // only if the window spans 3 chunks or more; else one slot per ring slot
  sh.jcn = sh.n / JC;
  sh.win_slots = sh.jcn >= 3 ? 2 : STAGES;
  auto smem_for = [&](int wg) {
    const size_t ring = (size_t)STAGES * TILE +
                        (size_t)sh.win_slots * wg * (sh.n + WIN_PAD);
    const size_t epi = Epilogue::smem(wg);
    return (ring > epi ? ring : epi) + 1024;
  };
  // as many planes per block as fit: at N = 16384 the windows of 4 do not
  int n_wg = planes_used < MAX_WG ? planes_used : MAX_WG;
  while (n_wg > 1 && smem_for(n_wg) > MAX_SMEM) --n_wg;
  const size_t smem = smem_for(n_wg);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  sh.n_wg = n_wg;
  const int groups = (planes_used + n_wg - 1) / n_wg;
  cudaError_t err = cudaFuncSetAttribute(
      banded_wgmma_kernel<Epilogue>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.n / TM, (sh.batch + BN - 1) / BN, sh.cout_n * groups);
  banded_wgmma_kernel<Epilogue><<<grid, n_wg * 128, smem, stream>>>(sh, ep);
  return (int)cudaGetLastError();
}

}  // namespace banded
