"""Blind-rotate output noise at the QuantizedMLP archive's parameters,
measured through the JAX package alone, on the CPU.

    JAX_PLATFORMS=cpu python tools/witness_br_noise.py [--ciphertexts 64]

A witness independent of the PyTorch port for the error rate that
``chip_smoke.py``'s direct 6-bit lookups are held to.  The archive
``concrete_tpu_torch/fixtures/mlp_q2_b64.zip`` fixes the parameters
(n_small=822, k=1, N=4096, l=2, base 2^8); the keys come from
``concrete_tpu.core.keygen``, the blind rotation is the JAX package's
exact CRT-NTT scan ``concrete_tpu.core.ntt_tpu.blind_rotate_ntt`` over
random input ciphertexts, and each output accumulator is decrypted with
``refimpl.glwe_decrypt``.  Every coefficient j of every accumulator is one
noise sample: its phase minus (X^-phi LUT)[j], where phi is the input's
modulus-switched phase.  A 6-bit output decodes wrong where |noise| >
2^-8, the noise model's margin (``params.p_error_from_variance``).

Prints one JSON line: the measured std, mean and wrong share (with its
standard error over ciphertexts) against the noise model's.  About three
minutes on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
ARCHIVE = os.path.join(REPO, "concrete_tpu_torch", "fixtures",
                       "mlp_q2_b64.zip")
BITS = 6
TABLE = [(3 * v + 1) % 64 for v in range(64)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ciphertexts", type=int, default=64)
    args = ap.parse_args()

    import concrete_tpu.jax_config  # noqa: F401
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from concrete_tpu import params as pp
    from concrete_tpu.compilation.specs import ClientSpecs
    from concrete_tpu.core import keygen as kg
    from concrete_tpu.core import ntt_tpu as nt
    from concrete_tpu.core import refimpl as ref

    with zipfile.ZipFile(ARCHIVE) as z:
        params = ClientSpecs.deserialize(
            z.read("client.specs.json").decode()).params
    n = params.polynomial_size
    rng = np.random.default_rng(20261016)
    t0 = time.perf_counter()
    sk_small = ref.sample_binary_key(rng, (params.n_small,))
    gsk = ref.sample_binary_key(rng, (params.glwe_dimension, n))
    bsk = kg.make_bsk(rng, sk_small, gsk, params)
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nbsk = nt.pack_bsk_ntt(bsk, params)
    del bsk
    pack_s = time.perf_counter() - t0

    ct = rng.integers(0, 1 << 64, (args.ciphertexts, params.n_small + 1),
                      dtype=np.uint64)
    lut = ref.encode_expand_lut(np.array(TABLE, dtype=np.uint64), n, BITS)
    t0 = time.perf_counter()
    acc = np.asarray(jax.jit(nt.blind_rotate_ntt, static_argnums=3)(
        jnp.asarray(ct), nbsk, jnp.asarray(lut), params))
    rotate_s = time.perf_counter() - t0

    noise = []
    for b in range(args.ciphertexts):
        switched = ref.modulus_switch(ct[b], params.log2_polynomial_size)
        phi = int((int(switched[-1])
                   - int(np.dot(switched[:-1].astype(np.int64),
                                sk_small.astype(np.int64)))) % (2 * n))
        want = ref.monomial_mul(lut, (2 * n - phi) % (2 * n))
        phase = ref.glwe_decrypt(gsk, acc[b])
        noise.append((phase - want).view(np.int64))
    noise = np.concatenate(noise).astype(np.float64) / 2.0 ** 64
    margin = 2.0 ** -(BITS + 2)
    v_br = pp.variance_blind_rotate(
        params.n_small, params.glwe_dimension, n, params.pbs_base_log,
        params.pbs_level, params.glwe_std ** 2, params.q_log)
    # one ciphertext's coefficients share much of their noise (the binary
    # GLWE key couples them), so the standard error comes from the spread
    # of the per-ciphertext shares
    shares = (np.abs(noise) > margin).reshape(args.ciphertexts, n).mean(1)
    wrong = int(np.count_nonzero(np.abs(noise) > margin))
    print(json.dumps({
        "params": {"n_small": params.n_small, "k": params.glwe_dimension,
                   "N": n, "pbs_level": params.pbs_level,
                   "pbs_base_log": params.pbs_base_log,
                   "glwe_std": params.glwe_std},
        "ciphertexts": args.ciphertexts, "samples": int(noise.size),
        "std_measured": float(noise.std()), "mean": float(noise.mean()),
        "std_model": math.sqrt(v_br),
        "wrong_6bit": wrong, "wrong_share": wrong / noise.size,
        "wrong_share_se": float(shares.std(ddof=1)
                                / math.sqrt(args.ciphertexts)),
        "wrong_share_model": pp.p_error_from_variance(v_br, BITS),
        "keygen_s": keygen_s, "pack_s": pack_s, "rotate_s": rotate_s}))


if __name__ == "__main__":
    main()
