// recombine_accumulate: shift-add of int32 limb-product planes into the u64
// accumulator, in place.
//
// Replaces the TPU kernel concrete_tpu/ops/pallas_step.py
// recombine_accumulate (:385, its body _recombine_kernel :355), which the
// JAX package's "pallas", "fuseddot" and "planes" banded modes run after the
// product.  On the TPU the accumulator is a (lo, hi) pair of u32 planes and
// every shifted plane is added with an explicit carry; here it is one
// int64 tensor, so each plane is sign-extended, shifted and added mod 2^64:
//
//   acc[row, t] += sum_p planes[row, p, t] << 8*(p + limb_offset)
//
// over the planes whose shift stays below 64 (the rest contribute nothing
// mod 2^64, so a caller may pass more planes than it keeps).
//
// Bound: bytes.  Each used plane is read once and the accumulator read and
// written once: at 2048 rows x 4 planes x N=1024 that is 33.5 MB of planes
// and 2 x 16.8 MB of accumulator, about 0.020 ms at 3.35 TB/s, against 5
// integer operations per plane element.  Design: one thread per accumulator
// element, consecutive threads on consecutive coefficients, so every plane
// row and the accumulator row are read in full 128-byte lines; a
// grid-stride loop covers any size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) recombine_kernel(
    const int* __restrict__ planes, unsigned long long* __restrict__ acc,
    long long total, int n, int n_planes, int used, int limb_offset) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / n;
    const int t = (int)(i - row * n);
    const int* pr = planes + (size_t)row * n_planes * n + t;
    unsigned long long add = 0;
    for (int p = 0; p < used; ++p)
      add += (unsigned long long)(long long)pr[(size_t)p * n]
             << (8 * (p + limb_offset));
    acc[i] += add;
  }
}

}  // namespace

extern "C" int recombine_accumulate(const void* planes, void* acc, int rows,
                                    int n_planes, int n, int limb_offset,
                                    void* stream) {
  const long long total = (long long)rows * n;
  int used = 8 - limb_offset;
  if (used > n_planes) used = n_planes;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
  recombine_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)planes, (unsigned long long*)acc, total, n, n_planes, used,
      limb_offset);
  return (int)cudaGetLastError();
}
