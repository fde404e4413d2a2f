// Kernel 3's runtime-key entry (the design is in crt_external_product.cuh):
// the external product of each ciphertext's digits with its own key from a
// stack of spectra, key_index[b] for ciphertext b.  The WoP vertical
// packing's CMUXes by the circuit bootstrap's GGSWs run here
// (ops/fused_ntt.py crt_external_product_keyed).  This source holds the C
// entry point and the k+1 = 2 instantiations, crt_external_product_keyed_
// wide.cu the k+1 >= 3 ones (crt_external_product_keyed.cuh): two nvcc
// processes beside the BSK entry's, whose instantiations stay as they are.

#include "crt_external_product_keyed.cuh"

extern "C" int crt_external_product_keyed_wide(
    const void* digits, const void* spec, const void* spec_sh, void* out,
    const void* tw, const void* consts, const void* key_index, int batch,
    int levels, int kp1, int n_primes, int log_n, int co_group,
    void* stream);

// digits (levels, batch * (k+1), N) int32; spec, spec_sh (n_keys, P * Cin *
// (k+1), N) u32, the stack of keys in the FusedBSK step layout; key_index
// (batch,) int32 in [0, n_keys); out (P, batch * (k+1), N) u32.  N =
// 2^log_n, 256 <= N <= 16384; k+1 >= 2 in groups of co_group.
extern "C" int crt_external_product_keyed(
    const void* digits, const void* spec, const void* spec_sh, void* out,
    const void* tw, const void* consts, const void* key_index, int batch,
    int levels, int kp1, int n_primes, int log_n, int co_group,
    void* stream) {
  if (kp1 == KR)
    return launch_keyed<false>(digits, spec, spec_sh, out, tw, consts,
                               key_index, batch, levels, kp1, n_primes, log_n,
                               co_group, stream);
  return crt_external_product_keyed_wide(digits, spec, spec_sh, out, tw,
                                         consts, key_index, batch, levels,
                                         kp1, n_primes, log_n, co_group,
                                         stream);
}
