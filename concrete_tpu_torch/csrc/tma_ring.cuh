// The pieces the two persistent blind-rotate kernels share for their key
// ring and their steps across a cluster (csrc/blind_rotate_latency.cu and
// csrc/blind_rotate_fused_latency.cu): a bulk copy (TMA) into shared
// memory counted on an mbarrier, the arrival that makes the mbarrier wait
// for its bytes, and the barrier that orders every block's shared-memory
// writes before every block's reads (whole, or in its two halves).

#pragma once

#include <cstdint>

namespace tma {

// Arrives on `bar`, which then also waits for `bytes` of async copies.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One bulk copy (TMA) of `bytes` (a multiple of 16, from a 16-byte
// aligned source) into this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Every block's shared-memory writes before it, visible to every block's
// reads after it.
__device__ __forceinline__ void cluster_barrier() {
#ifdef ABLATE_RELAXED_ARRIVE
  // (no release: times the fence the release adds; set only by
  // tools/ablate_kernels.py's builds of csrc/blind_rotate_latency.cu)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
#else
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
#endif
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The two halves of a cluster barrier, for a warp that writes nothing
// another block reads: it arrives, does its own work, then waits for the
// others.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

}  // namespace tma
