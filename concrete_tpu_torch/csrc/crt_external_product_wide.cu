// Kernel 3 of the CRT-NTT path (csrc/crt_external_product.cuh) compiled
// for k+1 >= 3, where the accumulators beyond two live in shared memory;
// its own source, so nvcc builds it beside the k+1 = 2 instantiations.

#include "crt_external_product.cuh"

extern "C" int crt_external_product_wide(const void* digits, const void* spec,
                                         const void* spec_sh, void* out,
                                         const void* tw, const void* consts,
                                         int batch, int levels, int kp1,
                                         int n_primes, int log_n,
                                         int co_group, void* stream) {
  return launch_n<true>(digits, spec, spec_sh, out, tw, consts, batch,
                        levels, kp1, n_primes, log_n, co_group, stream);
}
