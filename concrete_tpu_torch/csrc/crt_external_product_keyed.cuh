// Kernel 3's runtime-key entry, launch_keyed<WIDE>: the KEYED
// instantiations of crt_external_product.cuh at N = 256 .. 16384, for
// k+1 = 2 (WIDE false, csrc/crt_external_product_keyed.cu) or k+1 >= 3
// (csrc/crt_external_product_keyed_wide.cu).

#pragma once

#include "crt_external_product.cuh"

namespace {

template <bool WIDE>
int launch_keyed(const void* digits, const void* spec, const void* spec_sh,
                 void* out, const void* tw, const void* consts,
                 const void* key_index, int batch, int levels, int kp1,
                 int n_primes, int log_n, int co_group, void* stream) {
  if (WIDE ? kp1 <= KR || co_group < 1 || co_group > kp1
           : kp1 != KR || co_group != KR)
    return (int)cudaErrorInvalidValue;
#define CRT_XPK_CASE(L)                                                     \
  case L:                                                                   \
    return (int)launch<L, WIDE, true>(digits, spec, spec_sh, out, tw,       \
                                      consts, batch, levels, kp1,          \
                                      n_primes, co_group, stream,          \
                                      key_index);
  switch (log_n) {
    CRT_XPK_CASE(8) CRT_XPK_CASE(9) CRT_XPK_CASE(10) CRT_XPK_CASE(11)
    CRT_XPK_CASE(12) CRT_XPK_CASE(13) CRT_XPK_CASE(14)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CRT_XPK_CASE
}

}  // namespace
