// Kernel 3 of the CRT-NTT path (the design is in crt_external_product.cuh):
// its C entry point, and the kernel compiled for k+1 = 2.

#include "crt_external_product.cuh"

// tw: the paired tables of ops/ntt.pair_tables, (P, 2, N) pairs of
// (twiddle, Shoup companion), forward then inverse; consts (P, 3) u32.
// k+1 >= 2, in groups of co_group output components (ops/fused_ntt.py
// kernel_groups): (2 + max(co_group - 2, 0)) N 4 bytes of shared memory.
extern "C" int crt_external_product(const void* digits, const void* spec,
                                    const void* spec_sh, void* out,
                                    const void* tw, const void* consts,
                                    int batch, int levels, int kp1,
                                    int n_primes, int log_n, int co_group,
                                    void* stream) {
  if (kp1 == KR)
    return launch_n<false>(digits, spec, spec_sh, out, tw, consts, batch,
                           levels, kp1, n_primes, log_n, co_group, stream);
  return crt_external_product_wide(digits, spec, spec_sh, out, tw, consts,
                                   batch, levels, kp1, n_primes, log_n,
                                   co_group, stream);
}
