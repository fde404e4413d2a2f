#!/usr/bin/env python3
"""The noise a truncated fused key adds to a lookup, in both packages, on the
CPU (JAX_PLATFORMS=cpu, the port on its plain versions):

    JAX_PLATFORMS=cpu python tools/measure_fused_truncation.py 64 256

A lookup of PrivateInformationRetrieval 16 x 16's univariate shape (a 5-bit
input, a 7-bit output, (v * v) // 4) at its parameters (N=8192, k=1, l=1,
base 2^23, ks 6 x 3) with n_small cut to each argument, on 16 inputs: the
output phase minus its exact encoding, in output steps (2^-8 of the torus;
a decryption fails beyond half a step), with the fused key packed as the
truncation rule packs it (3 primes, 11 bits truncated) and untruncated (4
primes).  At the first n_small the JAX package's pbs_batch runs on the same
keys and inputs, and its outputs must equal the port's.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    from concrete_tpu.core import kernels as jkn
    from concrete_tpu.core import keygen as jkg
    from concrete_tpu.ops import pallas_fused_ntt as jpf
    from concrete_tpu.params import CryptoParams as JParams
    from concrete_tpu_torch.core import kernels as tkn
    from concrete_tpu_torch.core import ntt as host
    from concrete_tpu_torch.core import refimpl as ref
    from concrete_tpu_torch.ops import fused_ntt as tfn
    from concrete_tpu_torch.params import CryptoParams as TParams
    p_in, p_out = 5, 7
    lut = np.array([(v * v) // 4 for v in range(1 << p_in)], dtype=np.uint64)
    xs = np.arange(1, 17)
    pool = host.special_ntt_primes(8192, 128)
    for i, n_small in enumerate(int(a) for a in sys.argv[1:] or ["64"]):
        fields = dict(n_small=n_small, glwe_dimension=1, polynomial_size=8192,
                      pbs_level=1, pbs_base_log=23, ks_level=6, ks_base_log=3,
                      lwe_std=2.0 ** -40, glwe_std=2.0 ** -62,
                      security_level=0)
        jp, tp = JParams(**fields), TParams(**fields)
        sk, server = jkg.keygen(np.random.default_rng(0), jp)
        lut_poly = ref.encode_expand_lut(lut, 8192, p_in, out_bits=p_out)
        cts = jkg.encrypt_lwe_batch(np.random.default_rng(3), sk.lwe_big,
                                    ref.encode(xs, p_in), jp.glwe_std)
        want = ref.encode(lut[xs], p_out)
        ksk = tkn.pack_ksk(server.ksk, tp, device="cpu")
        for primes, t in ((pool[:3], 11), (pool[:4], 0)):
            bsk = tfn.pack_bsk_fused(server.bsk, tp, primes=primes,
                                     trunc_bits=t, device="cpu")
            t0 = time.perf_counter()
            out = tkn.pbs_batch(
                torch.from_numpy(cts.view(np.int64)), ksk, bsk,
                torch.from_numpy(lut_poly.view(np.int64)), tp,
                p_in).numpy().view(np.uint64)
            err = (ref.lwe_decrypt(sk.lwe_big, out) - want).view(np.int64) \
                / 2.0 ** (63 - p_out)
            line = (f"n_small={n_small}, {len(primes)} primes, t={t}: phase "
                    f"error in output steps mean {err.mean():+.4f} std "
                    f"{err.std():.4f} max |{np.abs(err).max():.4f}| "
                    f"({time.perf_counter() - t0:.1f} s)")
            if i == 0:
                jout = np.asarray(jkn.pbs_batch(
                    cts, jkn.pack_ksk(server.ksk, jp),
                    jpf.pack_bsk_fused(server.bsk, jp, primes=primes,
                                       trunc_bits=t), lut_poly, jp, p_in))
                line += f"; the JAX package's outputs equal: " \
                        f"{np.array_equal(jout, out)}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
