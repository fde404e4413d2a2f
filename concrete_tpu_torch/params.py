"""Cryptographic parameter types, security curves, and noise formulas.

A copy of ``concrete_tpu/params.py`` (the port imports nothing of the JAX
package), plus the two optimizer helpers ``choose_truncate_limbs`` needs
(``kappa_of_p_error`` and ``safe_variance_bound`` from
``concrete_tpu/optimizer/v0.py``); the TPU cost model is not copied.

This module is the analog of the reference's parameter machinery:

- security curves: fitted (slope, bias, min-dim) per security level, reference
  ``tools/parameter-curves/concrete-security-curves-rust/src/gaussian/curves_gen.rs:2-19``
  and ``security.rs:21-44`` (the constants are published lattice-estimator fits).
- noise formulas: reference ``backends/concrete-cpu/noise-model/src/gaussian_noise/noise/
  {keyswitch,external_product_glwe,blind_rotate,modulus_switching}.rs``.
- parameter sets: the shape of the reference's optimizer output
  (``concrete-optimizer/concrete-optimizer-cpp/src/concrete-optimizer.rs`` ``Solution``).

One deliberate difference from the reference: our external product / blind rotation is
computed with *exact* integer arithmetic mod 2^64 (limb-decomposed int8 matmul/convs on
the MXU) instead of the reference's f64 FFT.  The reference therefore has an additional
``fft_noise_variance`` term (``external_product_glwe.rs`` ``FFT_SCALING_WEIGHT``) which
for us is exactly zero.  We keep the formula around (``fft_noise_variance_external_product``)
so the simulator can also model reference behavior, but our own noise predicate uses
``fft_precision=None`` (exact arithmetic).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

# ---------------------------------------------------------------------------
# Security curves
# ---------------------------------------------------------------------------

#: security level -> (slope, bias, minimal lwe dimension)
#: Lattice-estimator fitted curves, reference curves_gen.rs:2-19.
SECURITY_WEIGHTS: dict[int, tuple[float, float, int]] = {
    128: (-0.025696778711484593, 2.675931372549016, 450),
    132: (-0.024891456582633045, 2.65734593837534, 450),
}


def secure_log2_std(lwe_dimension: int, security_level: int = 128,
                    ciphertext_modulus_log: int = 64) -> float:
    """Minimal secure log2(stddev) (torus units) for an LWE dimension.

    Reference: security_weights.rs ``SecurityWeights::secure_log2_std``.
    """
    slope, bias, min_dim = SECURITY_WEIGHTS[security_level]
    # minimal std covering the 2 lowest bits of the modular scale
    epsilon_log2_std = 2.0 - ciphertext_modulus_log
    if lwe_dimension >= min_dim:
        return max(slope * lwe_dimension + bias, epsilon_log2_std)
    return float(ciphertext_modulus_log)


def minimal_variance_lwe(lwe_dimension: int, security_level: int = 128,
                         ciphertext_modulus_log: int = 64) -> float:
    """Minimal secure noise variance (torus units) for LWE. security.rs:21-29."""
    return minimal_variance_glwe(lwe_dimension, 1, security_level,
                                 ciphertext_modulus_log)


def minimal_variance_glwe(glwe_dimension: int, polynomial_size: int,
                          security_level: int = 128,
                          ciphertext_modulus_log: int = 64) -> float:
    """Minimal secure noise variance (torus units) for GLWE. security.rs:30-44."""
    equiv = glwe_dimension * polynomial_size
    return 2.0 ** (2.0 * secure_log2_std(equiv, security_level,
                                         ciphertext_modulus_log))


# ---------------------------------------------------------------------------
# Noise model (torus-unit variances; modular variance = variance * q^2)
# ---------------------------------------------------------------------------

def _mod_var_to_var(modular_variance: float, q_log: int = 64) -> float:
    return modular_variance / 2.0 ** (2 * q_log)


def variance_keyswitch(input_lwe_dimension: int, log2_base: int, level: int,
                       variance_ksk: float, q_log: int = 64) -> float:
    """Additional variance from a keyswitch. Reference keyswitch.rs / keyswitch_one_bit.rs."""
    var_key = _mod_var_to_var(1.0 / 4.0, q_log)           # binary key coeff variance
    sq_exp_key = _mod_var_to_var((1.0 / 2.0) ** 2, q_log)  # squared expectation
    base = 2.0 ** log2_base
    b2l = 2.0 ** (2 * log2_base * level)
    q_sq = 2.0 ** (2 * q_log)
    res_2 = (q_sq / (12.0 * b2l) - 1.0 / 12.0) * (var_key + sq_exp_key)
    res_3 = 1.0 / 4.0 * var_key
    res_4 = level * variance_ksk * (base ** 2 + 2.0) / 12.0
    return input_lwe_dimension * (res_2 + res_3 + res_4)


def variance_external_product(glwe_dimension: int, polynomial_size: int,
                              log2_base: int, level: int, variance_ggsw: float,
                              q_log: int = 64,
                              fft_precision: Optional[int] = None) -> float:
    """Variance added by one external product (GGSW x GLWE).

    Reference external_product_glwe.rs.  ``fft_precision=None`` means exact
    integer arithmetic (our TPU kernels): no FFT rounding noise term.
    """
    var_key = _mod_var_to_var(1.0 / 4.0, q_log)
    sq_exp_key = _mod_var_to_var((1.0 / 2.0) ** 2, q_log)
    k = float(glwe_dimension)
    b = 2.0 ** log2_base
    b2l = 2.0 ** (2 * log2_base * level)
    n = float(polynomial_size)
    q_sq = 2.0 ** (2 * q_log)
    res_1 = level * (k + 1.0) * n * (b ** 2 + 2.0) / 12.0 * variance_ggsw
    res_2 = ((q_sq - b2l) / (24.0 * b2l)
             * (_mod_var_to_var(1.0, q_log) + k * n * (var_key + sq_exp_key))
             + k * n / 8.0 * var_key
             + 1.0 / 16.0 * (1.0 - k * n) ** 2 * sq_exp_key)
    out = res_1 + res_2
    if fft_precision is not None:
        out += fft_noise_variance_external_product(
            glwe_dimension, polynomial_size, log2_base, level, q_log,
            fft_precision)
    return out


#: reference external_product_glwe.rs FFT_SCALING_WEIGHT (f64-FFT path only)
FFT_SCALING_WEIGHT: float = -2.57722494


def fft_noise_variance_external_product(glwe_dimension: int, polynomial_size: int,
                                        log2_base: int, level: int,
                                        q_log: int = 64,
                                        fft_precision: int = 53) -> float:
    """FFT rounding noise of the *reference's* f64 path; zero for our exact kernels."""
    b = 2.0 ** log2_base
    lost_bits = q_log - fft_precision
    res = (2.0 ** FFT_SCALING_WEIGHT * 2.0 ** (2 * lost_bits) * level * b * b
           * float(polynomial_size) ** 2 * (glwe_dimension + 1.0))
    return _mod_var_to_var(res, q_log)


def variance_bsk_limb_truncation(in_lwe_dimension: int, glwe_dimension: int,
                                 polynomial_size: int, log2_base: int,
                                 level: int, truncate_limbs: int,
                                 q_log: int = 64) -> float:
    """Extra blind-rotate variance from dropping the lowest `truncate_limbs`
    8-bit limb planes of the BSK in the banded-matmul kernel (our analog of
    the reference's fft noise term, but exactly characterizable).

    Per CMUX output coefficient the truncation error is
    sum over (k+1)*l*N digit products of d * t with |d| <= 2^(B-1) and
    t uniform-ish in [0, 2^(8*truncate_limbs)); variance ~= count * E[d^2] *
    E[t^2] / q^2, summed over the n CMUXes of a blind rotation.
    """
    if truncate_limbs == 0:
        return 0.0
    count = (glwe_dimension + 1) * level * polynomial_size
    e_d2 = (2.0 ** (log2_base - 1)) ** 2 / 3.0
    e_t2 = (2.0 ** (8 * truncate_limbs)) ** 2 / 3.0
    per_coeff = in_lwe_dimension * count * e_d2 * e_t2 / 2.0 ** (2 * q_log)
    # the error lands on every GLWE component; mask-coefficient errors are
    # multiplied by the (binary) key at phase evaluation:
    # Var + E^2 of key coeffs = 1/4 + 1/4 per mask coefficient
    key_factor = 1.0 + glwe_dimension * polynomial_size / 2.0
    return per_coeff * key_factor


def variance_bsk_truncation_bits(in_lwe_dimension: int, glwe_dimension: int,
                                 polynomial_size: int, log2_base: int,
                                 level: int, bits: int,
                                 q_log: int = 64) -> float:
    """variance_bsk_limb_truncation generalized to an arbitrary number of
    truncated low BITS (the CRT-NTT path drops bits, not 8-bit limbs, to
    shrink the exact-range requirement to fewer primes)."""
    if bits == 0:
        return 0.0
    count = (glwe_dimension + 1) * level * polynomial_size
    e_d2 = (2.0 ** (log2_base - 1)) ** 2 / 3.0
    e_t2 = (2.0 ** bits) ** 2 / 3.0
    per_coeff = in_lwe_dimension * count * e_d2 * e_t2 / 2.0 ** (2 * q_log)
    key_factor = 1.0 + glwe_dimension * polynomial_size / 2.0
    return per_coeff * key_factor


@functools.lru_cache(maxsize=None)
def kappa_of_p_error(p_error: float) -> float:
    """sigma scale with P(|x| > kappa*sigma) = p_error (reference error.rs).

    Cached: the parameter search asks for the same few p_error values
    millions of times (a 200-step bisection each)."""
    # invert erfc by bisection (p_error in (0, 1)); avoids a scipy dependency
    lo, hi = 0.0, 40.0
    for _ in range(200):
        mid = (lo + hi) / 2
        if math.erfc(mid / math.sqrt(2.0)) > p_error:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def safe_variance_bound(precision: int, p_error: float) -> float:
    """Reference error.rs safe_variance_bound_2padbits (torus units)."""
    margin = 2.0 ** (-(precision + 2))
    return (margin / kappa_of_p_error(p_error)) ** 2


def choose_truncate_limbs(params: "CryptoParams", message_bits: int,
                          norm2: int = 1,
                          budget_fraction: float = 0.05,
                          p_error: float = 6.3e-5) -> int:
    """Largest BSK limb truncation whose added variance stays below
    `budget_fraction` of the safe variance bound for `message_bits`.

    The truncation error rides the blind-rotate output, so like the BR
    variance itself it is amplified by norm2^2 by downstream leveled ops
    before the next decision point — the budget check scales it accordingly.

    Small gadget bases tolerate deep truncation (digits are tiny); e.g. the
    TPU-optimizer's base-32 parameters allow dropping 4 of 8 limb planes at
    ~2^-37 added variance."""
    budget = safe_variance_bound(message_bits, p_error) * budget_fraction
    amp = float(norm2) ** 2
    best = 0
    for t in range(1, 7):
        v = variance_bsk_limb_truncation(
            params.n_small, params.glwe_dimension, params.polynomial_size,
            params.pbs_base_log, params.pbs_level, t, params.q_log) * amp
        if v <= budget:
            best = t
    return best


def variance_blind_rotate(in_lwe_dimension: int, glwe_dimension: int,
                          polynomial_size: int, log2_base: int, level: int,
                          variance_bsk: float, q_log: int = 64,
                          fft_precision: Optional[int] = None) -> float:
    """Output variance of a blind rotation (fresh: independent of input noise).

    Reference blind_rotate.rs: in_lwe_dimension * variance_cmux(...).
    """
    return in_lwe_dimension * variance_external_product(
        glwe_dimension, polynomial_size, log2_base, level, variance_bsk,
        q_log, fft_precision)


def variance_modulus_switch(internal_lwe_dimension: int,
                            glwe_log2_polynomial_size: int,
                            q_log: int = 64) -> float:
    """Variance added by the modulus switch before blind rotation.

    Reference modulus_switching.rs (binary key).
    """
    nb_msb = glwe_log2_polynomial_size + 1
    w = 2.0 ** nb_msb
    n = float(internal_lwe_dimension)
    return ((1.0 / 12.0 + n / 24.0) / w ** 2
            + _mod_var_to_var(-1.0 / 12.0 + n / 48.0, q_log))


def variance_private_packing_keyswitch(n_big: int, glwe_dimension: int,
                                       polynomial_size: int, log2_base: int,
                                       level: int, variance_glwe: float,
                                       q_log: int = 64) -> float:
    """Per-coefficient variance added by one private functional packing
    keyswitch (LWE -> GLWE with the message multiplied by the key's secret
    function v_r, wop.private_packing_keyswitch).

    Same derivation shape as variance_keyswitch (reference noise-model
    private packing keyswitch): decomposition rounding of each input
    coefficient couples to the binary key AND the binary key polynomial
    v_r; encryption noise of the (n_big+1) * level GLWE rows rides the
    gadget digits.  Validated empirically in tests/test_wop_frontend.py.
    """
    var_key = _mod_var_to_var(1.0 / 4.0, q_log)
    sq_exp_key = _mod_var_to_var((1.0 / 2.0) ** 2, q_log)
    base = 2.0 ** log2_base
    b2l = 2.0 ** (2 * log2_base * level)
    q_sq = 2.0 ** (2 * q_log)
    # rounding error of each input coeff x binary s_i x binary v_r coeff
    rho = (q_sq / (12.0 * b2l) - 1.0 / 12.0)
    res_round = n_big * rho * (var_key + sq_exp_key) * (0.25 + 0.25) \
        + rho * _mod_var_to_var(1.0, q_log)  # body row (v = 1)
    res_enc = (n_big + 1) * level * variance_glwe * (base ** 2 + 2.0) / 12.0
    return res_round + res_enc


def wop_ggsw_variance(params: "CryptoParams", cbs_base_log: int,
                      cbs_level: int, pfks_base_log: int,
                      pfks_level: int) -> float:
    """Per-coefficient noise variance of a circuit-bootstrapped GGSW.

    The sign-PBS output noise (fresh blind rotate) passes through the
    PFPKSK, where it is multiplied by the binary key polynomial v_r; plus
    the packing keyswitch's own noise."""
    var_bit = variance_blind_rotate(
        params.n_small, params.glwe_dimension, params.polynomial_size,
        params.pbs_base_log, params.pbs_level, params.glwe_std ** 2,
        params.q_log)
    v_pfks = variance_private_packing_keyswitch(
        params.n_big, params.glwe_dimension, params.polynomial_size,
        pfks_base_log, pfks_level, params.glwe_std ** 2, params.q_log)
    return var_bit * 0.5 + v_pfks


def wop_output_variance(params: "CryptoParams", nb_bits: int,
                        cbs_base_log: int, cbs_level: int,
                        pfks_base_log: int, pfks_level: int) -> float:
    """Output noise variance of a WoP-PBS TLU over nb_bits extracted bits.

    Vertical packing = nb_bits CMUXes on the accumulator path (tree depth +
    in-chunk rotations), each an external product with the
    circuit-bootstrapped GGSW noise."""
    var_ggsw = wop_ggsw_variance(params, cbs_base_log, cbs_level,
                                 pfks_base_log, pfks_level)
    v_cmux = variance_external_product(
        params.glwe_dimension, params.polynomial_size, cbs_base_log,
        cbs_level, var_ggsw, params.q_log)
    return nb_bits * v_cmux


def p_error_from_variance(variance: float, message_bits: int,
                          norm2: int = 1, q_log: int = 64) -> float:
    """Probability that accumulated noise flips the (p+1)-bit encoded message.

    The decision margin is half a mega-case of the (p+1)-bit encoding
    (reference noise_estimator/p_error.rs semantics: gaussian tail beyond
    2^-(p+2) of the torus).
    """
    # width of one encoded step on the torus: 2^-(p+1); error if |noise| > half step
    margin = 2.0 ** (-(message_bits + 2))
    std = math.sqrt(variance)
    if std == 0.0:
        return 0.0
    z = margin / std
    return math.erfc(z / math.sqrt(2.0))


# ---------------------------------------------------------------------------
# Parameter sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CryptoParams:
    """A full single-keyset TFHE parameter solution.

    Mirrors the reference optimizer's ``Solution`` struct
    (concrete-optimizer-cpp/src/concrete-optimizer.rs) re-expressed for the
    KS->(modswitch)->BR atomic pattern over q = 2^64.
    """

    n_small: int            # LWE dimension after keyswitch (blind-rotate input)
    glwe_dimension: int     # k
    polynomial_size: int    # N
    pbs_level: int          # l   (blind rotate / BSK decomposition levels)
    pbs_base_log: int       # b
    ks_level: int
    ks_base_log: int
    lwe_std: float          # stddev (torus units) of fresh small-LWE noise
    glwe_std: float         # stddev (torus units) of fresh GLWE noise
    security_level: int = 128
    q_log: int = 64

    @property
    def n_big(self) -> int:
        """Large LWE dimension (sample-extracted GLWE key) = k * N."""
        return self.glwe_dimension * self.polynomial_size

    @property
    def log2_polynomial_size(self) -> int:
        return int(self.polynomial_size).bit_length() - 1

    @classmethod
    def make(cls, n_small: int, glwe_dimension: int, polynomial_size: int,
             pbs_level: int, pbs_base_log: int, ks_level: int, ks_base_log: int,
             security_level: int = 128) -> "CryptoParams":
        """Build a parameter set with curve-minimal secure noise."""
        lwe_std = math.sqrt(minimal_variance_lwe(n_small, security_level))
        glwe_std = math.sqrt(minimal_variance_glwe(
            glwe_dimension, polynomial_size, security_level))
        return cls(n_small=n_small, glwe_dimension=glwe_dimension,
                   polynomial_size=polynomial_size, pbs_level=pbs_level,
                   pbs_base_log=pbs_base_log, ks_level=ks_level,
                   ks_base_log=ks_base_log, lwe_std=lwe_std,
                   glwe_std=glwe_std, security_level=security_level)

    # -- noise predicate ---------------------------------------------------

    def atomic_pattern_variance(self, norm2: int = 1,
                                fft_precision: Optional[int] = None) -> float:
        """Worst-case variance at the blind-rotate decision point for the
        V0 atomic pattern: fresh BR output -> x norm2 (dot with weights) ->
        keyswitch -> modswitch.  Reference atomic_pattern.rs semantics."""
        v_br = variance_blind_rotate(
            self.n_small, self.glwe_dimension, self.polynomial_size,
            self.pbs_base_log, self.pbs_level, self.glwe_std ** 2,
            self.q_log, fft_precision)
        v_after_dot = v_br * float(norm2) ** 2
        v_ks = variance_keyswitch(self.n_big, self.ks_base_log, self.ks_level,
                                  self.lwe_std ** 2, self.q_log)
        v_ms = variance_modulus_switch(self.n_small,
                                       self.log2_polynomial_size, self.q_log)
        return v_after_dot + v_ks + v_ms

    def p_error(self, message_bits: int, norm2: int = 1,
                fft_precision: Optional[int] = None) -> float:
        return p_error_from_variance(
            self.atomic_pattern_variance(norm2, fft_precision), message_bits)


# Pinned bench/default parameter sets, 128-bit security, norm2=1, p_error
# ~6.3e-5 — matching the reference optimizer's V0 table rows
# (v0-parameters/ref/v0_last_128: precision-4 row "2, 10, 801, 1, 23, 3, 4"
# and precision-6 row "1, 12, 880, 1, 22, 4, 4"); our noise model reproduces
# the table's p_error column to 2 significant digits (see tests/test_params.py).
# The default table generated by our own optimizer lives in
# concrete_tpu/optimizer/; BENCH_* are pinned so benchmarks stay stable.
BENCH_PARAMS_4BIT = CryptoParams.make(
    n_small=801, glwe_dimension=2, polynomial_size=1024,
    pbs_level=1, pbs_base_log=23, ks_level=3, ks_base_log=4)

# Our own V0 optimizer's pick for 4-bit under the TPU int8-MAC cost model
# (optimize_v0(4)): single-limb gadget digits (base 32) make the banded
# matmul ~2x cheaper than the reference-style (1, 23) decomposition.
BENCH_PARAMS_4BIT_TPUOPT = CryptoParams.make(
    n_small=710, glwe_dimension=1, polynomial_size=1024,
    pbs_level=4, pbs_base_log=5, ks_level=8, ks_base_log=2)

BENCH_PARAMS_6BIT = CryptoParams.make(
    n_small=880, glwe_dimension=1, polynomial_size=4096,
    pbs_level=1, pbs_base_log=22, ks_level=4, ks_base_log=4)

# Tiny, insecure parameters for fast unit tests (NOT SECURE).
TEST_PARAMS_TINY = CryptoParams(
    n_small=16, glwe_dimension=2, polynomial_size=64,
    pbs_level=2, pbs_base_log=12, ks_level=2, ks_base_log=8,
    lwe_std=2.0 ** -25, glwe_std=2.0 ** -35, security_level=0)

# Slightly wider tiny parameters: N=256 keeps the modulus-switch noise low
# enough for 5-6-bit (e.g. packed multivariate) tests.  Still NOT SECURE.
TEST_PARAMS_TINY_WIDE = CryptoParams(
    n_small=32, glwe_dimension=1, polynomial_size=256,
    pbs_level=2, pbs_base_log=12, ks_level=2, ks_base_log=8,
    lwe_std=2.0 ** -30, glwe_std=2.0 ** -40, security_level=0)
