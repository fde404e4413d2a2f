// Kernel 3's runtime-key entry (csrc/crt_external_product_keyed.cu)
// compiled for k+1 >= 3; its own source, so nvcc builds it beside the
// k+1 = 2 instantiations.

#include "crt_external_product_keyed.cuh"

extern "C" int crt_external_product_keyed_wide(
    const void* digits, const void* spec, const void* spec_sh, void* out,
    const void* tw, const void* consts, const void* key_index, int batch,
    int levels, int kp1, int n_primes, int log_n, int co_group,
    void* stream) {
  return launch_keyed<true>(digits, spec, spec_sh, out, tw, consts,
                            key_index, batch, levels, kp1, n_primes, log_n,
                            co_group, stream);
}
