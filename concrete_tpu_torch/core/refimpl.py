"""Pure-NumPy reference implementation of the TFHE crypto core (the oracle).

Everything here is exact u64 (mod 2^64) arithmetic.  This module defines the
*semantics* that the port's kernels in ``concrete_tpu_torch.core.kernels`` and
``concrete_tpu_torch.ops`` must reproduce bit-for-bit.  It is deliberately simple and
slow (schoolbook polynomial multiplication); it is used only by tests and as
documentation of the math.

Semantics are aligned with the reference stack (file:line cites into the
upstream Concrete repository):

- message encoding/decoding: p bits + 1 padding bit,
  ``compiler/lib/Common/Transformers.cpp:364-427``.
- LUT encode/expand for bootstrap: mega-cases with half-rotated first case,
  ``compiler/lib/Runtime/wrappers.cpp:388-452``.
- modulus switch rounding: ``compiler/lib/Runtime/simulation.cpp:60-75``.
- blind rotate/sample-extract contract: ``simulation.cpp:77-113``.
- keyswitch/bootstrap call semantics: ``compiler/lib/Runtime/wrappers.cpp:629,762``
  (backed by tfhe-rs core_crypto via concrete-cpu's C API).

One documented divergence: the reference computes the external product through
an f64 FFT (tfhe-rs + concrete-fft) and thus has FFT rounding noise; we compute
it *exactly* mod 2^64, so our ciphertexts differ bit-wise from tfhe-rs after a
bootstrap even though decrypted plaintexts and noise bounds agree (and our
noise is strictly smaller: no fft term).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from concrete_tpu_torch.params import CryptoParams

U64 = np.uint64
_Q_LOG = 64


# ---------------------------------------------------------------------------
# Torus encode / decode (Transformers.cpp:364-427)
# ---------------------------------------------------------------------------

def encode(message, message_bits: int) -> np.ndarray:
    """Encode p-bit (signed or unsigned) integers into the u64 torus.

    m -> m << (64 - (p+1)): p message bits plus one padding bit.
    """
    m = np.asarray(message, dtype=np.int64)
    return (m.astype(np.uint64)) << U64(_Q_LOG - (message_bits + 1))


def decode(torus_value, message_bits: int, signed: bool = False) -> np.ndarray:
    """Round-to-nearest decode of a torus value to a p-bit integer.

    Transformers.cpp:385-427: shift down to p+2 bits, round via carry bit,
    reduce mod 2^(p+1) (the padding bit folds away), then sign-extend.
    """
    t = np.asarray(torus_value, dtype=np.uint64)
    p = message_bits
    out = t >> U64(_Q_LOG - p - 2)
    carry = out & U64(1)
    out = ((out >> U64(1)) + carry) & U64((1 << (p + 1)) - 1)
    if signed:
        # value is m mod 2^(p+1); sign-extend when >= 2^(p-1)
        # (Transformers.cpp:385-427: OR with ~0 << p)
        res = out.astype(np.int64)
        res = np.where(res >= np.int64(1 << (p - 1)),
                       res | np.int64(-1 << p), res)
        return res
    return (out & U64((1 << p) - 1)).astype(np.int64)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_torus_gaussian(rng: np.random.Generator, std: float, shape) -> np.ndarray:
    """Gaussian noise on the torus (std in torus units), rounded to u64."""
    x = rng.normal(0.0, std, size=shape)
    return np.round(x * 2.0 ** 64).astype(np.int64).astype(np.uint64)


def sample_uniform_u64(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


def sample_binary_key(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 2, size=shape, dtype=np.uint64)


# ---------------------------------------------------------------------------
# Negacyclic polynomial arithmetic mod (X^N + 1), coefficients mod 2^64
# ---------------------------------------------------------------------------

def negacyclic_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of u64 coefficient vectors (schoolbook)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    n = a.shape[-1]
    out = np.zeros(a.shape[:-1] + (2 * n,), dtype=np.uint64)
    for i in range(n):
        out[..., i:i + n] += a[..., i:i + 1] * b
    return out[..., :n] - out[..., n:]


def monomial_mul(poly: np.ndarray, r) -> np.ndarray:
    """X^r * poly  mod (X^N + 1), r in [0, 2N).  Vectorized over leading dims.

    (X^r p)[j] = p[(j - r) mod N] * (-1)^{floor((j - r) mod 2N / N)}.
    """
    poly = np.asarray(poly, dtype=np.uint64)
    n = poly.shape[-1]
    r = int(r) % (2 * n)
    j = np.arange(n)
    src = (j - r) % (2 * n)
    neg = src >= n
    src = src % n
    out = np.take(poly, src, axis=-1)
    out = np.where(neg, (-out.astype(np.int64)).astype(np.uint64), out)
    return out


# ---------------------------------------------------------------------------
# Gadget decomposition (balanced, closed-form; parallel across levels)
# ---------------------------------------------------------------------------

def decompose(value: np.ndarray, base_log: int, levels: int) -> np.ndarray:
    """Balanced signed gadget decomposition of u64 values.

    Returns int64 digits d[..., j] for level j+1 (weight 2^(64-(j+1)*B)) with
    d in (-2^(B-1), 2^(B-1)], such that
        sum_j d[..., j] << (64 - (j+1)B)  ==  round_to_multiple(value, 2^(64-lB))
    (mod 2^64).  Rounding is half-up, matching the closest-representable
    rounding of the reference path (tfhe-rs decomposer semantics at the level
    of the rounded value; the per-digit tie-breaking may differ, which only
    affects which valid decomposition is chosen, not correctness or noise).
    """
    v = np.asarray(value, dtype=np.uint64)
    b = base_log
    assert levels * b <= 63, "decomposition must keep at least one dropped bit"
    # w_j = round_half_up(v / 2^(64 - j*b)) for j = 0..levels, via
    # w_j = ((v >> (64 - j*b - 1)) + 1) >> 1
    ws = []
    for j in range(levels + 1):
        shift = _Q_LOG - j * b - 1
        ws.append(((v >> U64(shift)) + U64(1)) >> U64(1))
    digits = np.empty(v.shape + (levels,), dtype=np.int64)
    for j in range(1, levels + 1):
        d = ws[j] - (ws[j - 1] << U64(b))
        digits[..., j - 1] = d.astype(np.int64)  # wraps to signed correctly
    return digits


def recompose(digits: np.ndarray, base_log: int) -> np.ndarray:
    """Inverse of :func:`decompose` (up to the dropped low bits)."""
    levels = digits.shape[-1]
    out = np.zeros(digits.shape[:-1], dtype=np.uint64)
    for j in range(1, levels + 1):
        out += digits[..., j - 1].astype(np.uint64) << U64(_Q_LOG - j * base_log)
    return out


# ---------------------------------------------------------------------------
# LWE
# ---------------------------------------------------------------------------

def lwe_encrypt(rng: np.random.Generator, sk: np.ndarray, m_torus,
                std: float) -> np.ndarray:
    """LWE ciphertext [a_0..a_{n-1}, b] with b = <a, s> + m + e (mod 2^64)."""
    n = sk.shape[-1]
    m_torus = np.asarray(m_torus, dtype=np.uint64)
    a = sample_uniform_u64(rng, m_torus.shape + (n,))
    e = sample_torus_gaussian(rng, std, m_torus.shape)
    body = (a * sk).sum(axis=-1, dtype=np.uint64) + m_torus + e
    return np.concatenate([a, body[..., None]], axis=-1)


def lwe_decrypt(sk: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """Phase b - <a, s> (mod 2^64); decode separately."""
    a, b = ct[..., :-1], ct[..., -1]
    return b - (a * sk).sum(axis=-1, dtype=np.uint64)


def lwe_trivial(m_torus, n: int) -> np.ndarray:
    m_torus = np.asarray(m_torus, dtype=np.uint64)
    out = np.zeros(m_torus.shape + (n + 1,), dtype=np.uint64)
    out[..., -1] = m_torus
    return out


# ---------------------------------------------------------------------------
# GLWE
# ---------------------------------------------------------------------------

def glwe_encrypt(rng: np.random.Generator, gsk: np.ndarray, m_poly: np.ndarray,
                 std: float) -> np.ndarray:
    """GLWE ciphertext [(A_0..A_{k-1}, B)] with B = sum A_i*S_i + M + E.

    gsk: (k, N) binary polynomials; m_poly: (..., N) torus polynomial.
    Returns (..., k+1, N).
    """
    k, n = gsk.shape
    m_poly = np.asarray(m_poly, dtype=np.uint64)
    batch = m_poly.shape[:-1]
    a = sample_uniform_u64(rng, batch + (k, n))
    e = sample_torus_gaussian(rng, std, batch + (n,))
    body = m_poly + e
    for i in range(k):
        body = body + negacyclic_polymul(a[..., i, :], gsk[i])
    return np.concatenate([a, body[..., None, :]], axis=-2)


def glwe_decrypt(gsk: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """Phase polynomial B - sum A_i*S_i."""
    k = gsk.shape[0]
    phase = ct[..., k, :].copy()
    for i in range(k):
        phase -= negacyclic_polymul(ct[..., i, :], gsk[i])
    return phase


def glwe_trivial(m_poly: np.ndarray, k: int) -> np.ndarray:
    m_poly = np.asarray(m_poly, dtype=np.uint64)
    out = np.zeros(m_poly.shape[:-1] + (k + 1, m_poly.shape[-1]), dtype=np.uint64)
    out[..., k, :] = m_poly
    return out


# ---------------------------------------------------------------------------
# GGSW and the external product
# ---------------------------------------------------------------------------

def ggsw_encrypt(rng: np.random.Generator, gsk: np.ndarray, m: int,
                 base_log: int, levels: int, std: float) -> np.ndarray:
    """GGSW encryption of small integer m under GLWE key gsk.

    Layout (levels, k+1, k+1, N): rows [j][r] = GLWE(-m * S_r * 2^(64-(j+1)B))
    for r < k and GLWE(m * 2^(64-(j+1)B)) for r = k.
    """
    k, n = gsk.shape
    out = np.empty((levels, k + 1, k + 1, n), dtype=np.uint64)
    for j in range(levels):
        g = U64(1) << U64(_Q_LOG - (j + 1) * base_log)
        for r in range(k + 1):
            if r < k:
                msg = (-(np.int64(m)) * gsk[r].astype(np.int64)).astype(np.uint64) * g
            else:
                msg = np.zeros(n, dtype=np.uint64)
                msg[0] = U64(np.int64(m)) * g
            out[j, r] = glwe_encrypt(rng, gsk, msg, std)
    return out


def external_product(ggsw: np.ndarray, glwe_ct: np.ndarray, base_log: int,
                     levels: int) -> np.ndarray:
    """GGSW (.) GLWE -> GLWE via gadget decomposition.

    out = sum_{r=0..k, j=0..l-1} Decomp_j(C_r) (*) ggsw[j][r]   (GLWE sum).
    """
    k = glwe_ct.shape[-2] - 1
    n = glwe_ct.shape[-1]
    digits = decompose(glwe_ct, base_log, levels)        # (..., k+1, N, l)
    out = np.zeros(glwe_ct.shape, dtype=np.uint64)
    for r in range(k + 1):
        for j in range(levels):
            d = digits[..., r, :, j].astype(np.uint64)   # signed digits wrap ok
            for c in range(k + 1):
                out[..., c, :] += negacyclic_polymul(d, ggsw[j, r, c])
    return out


def cmux(ggsw_bit: np.ndarray, ct0: np.ndarray, ct1: np.ndarray,
         base_log: int, levels: int) -> np.ndarray:
    """ct0 + ggsw_bit (.) (ct1 - ct0): selects ct1 when the bit is 1."""
    return ct0 + external_product(ggsw_bit, ct1 - ct0, base_log, levels)


# ---------------------------------------------------------------------------
# Modulus switch, LUT expansion, blind rotation, sample extraction
# ---------------------------------------------------------------------------

def modulus_switch(value: np.ndarray, log2_poly_size: int) -> np.ndarray:
    """Switch torus u64 values to Z_{2N}: simulation.cpp:60-75 rounding."""
    v = np.asarray(value, dtype=np.uint64)
    shift = U64(_Q_LOG - log2_poly_size - 2)
    v = v >> shift
    v = v + (v & U64(1))
    v = v >> U64(1)
    return v & U64((1 << (log2_poly_size + 1)) - 1)


def encode_expand_lut(lut: np.ndarray, poly_size: int, message_bits: int,
                      signed: bool = False,
                      out_bits: int = None) -> np.ndarray:
    """Expand a 2^p-entry LUT into an N-coefficient accumulator polynomial.

    wrappers.cpp:388-452: each entry occupies a mega-case of N/2^p slots,
    shifted so case boundaries are centered (first case half at the start,
    half negated at the end); signed LUTs are half-rotated.

    `message_bits` is the *input* precision (the index domain); `out_bits`
    (default: same) sets the output encoding scale — they differ when a TLU
    crosses precision partitions (reference encode_expand uses
    out_MESSAGE_BITS for the shift while the table length is the input's).
    """
    lut = np.asarray(lut, dtype=np.uint64)
    p_size = lut.shape[-1]
    assert p_size == 1 << message_bits
    if out_bits is None:
        out_bits = message_bits
    mega = poly_size // p_size
    assert mega % 2 == 0, "polynomial size must give even mega-cases"
    if signed:
        half = p_size // 2
        lut = np.concatenate([lut[..., half:], lut[..., :half]], axis=-1)
    scaled = lut << U64(_Q_LOG - out_bits - 1)
    naive = np.repeat(scaled, mega, axis=-1)
    return monomial_mul(naive, 2 * poly_size - mega // 2)  # X^{-mega/2}


def blind_rotate(lwe_ct: np.ndarray, bsk: np.ndarray, lut_poly: np.ndarray,
                 params: CryptoParams) -> np.ndarray:
    """Blind rotation of the accumulator by the (mod-switched) LWE phase.

    acc = X^{-b~} * LUT; for each i: acc <- CMUX(bsk[i], acc, X^{a~_i} acc).
    Returns the final GLWE accumulator.
    """
    n = params.polynomial_size
    k = params.glwe_dimension
    switched = modulus_switch(lwe_ct, params.log2_polynomial_size)
    a_t, b_t = switched[:-1], int(switched[-1])
    acc = glwe_trivial(monomial_mul(lut_poly, 2 * n - b_t), k)
    for i in range(params.n_small):
        rot = np.empty_like(acc)
        for c in range(k + 1):
            rot[c] = monomial_mul(acc[c], int(a_t[i]))
        acc = cmux(bsk[i], acc, rot, params.pbs_base_log, params.pbs_level)
    return acc


def sample_extract(glwe_ct: np.ndarray, index: int = 0) -> np.ndarray:
    """Extract coefficient `index` of a GLWE phase as an LWE ciphertext under
    the flattened GLWE key (s'_{rN+t} = Z_r[t])."""
    k = glwe_ct.shape[-2] - 1
    n = glwe_ct.shape[-1]
    a_out = np.empty(glwe_ct.shape[:-2] + (k * n,), dtype=np.uint64)
    for r in range(k):
        a_poly = glwe_ct[..., r, :]
        # a'_{rN+t} = A_r[(index - t) mod N] with negacyclic sign
        t = np.arange(n)
        src = (index - t) % (2 * n)
        neg = src >= n
        src = src % n
        vals = np.take(a_poly, src, axis=-1)
        vals = np.where(neg, (-vals.astype(np.int64)).astype(np.uint64), vals)
        a_out[..., r * n:(r + 1) * n] = vals
    body = glwe_ct[..., k, index]
    return np.concatenate([a_out, body[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Keyswitch
# ---------------------------------------------------------------------------

def keyswitch_keygen(rng: np.random.Generator, sk_in: np.ndarray,
                     sk_out: np.ndarray, base_log: int, levels: int,
                     std: float) -> np.ndarray:
    """KSK[i][j] = LWE_{sk_out}(sk_in[i] * 2^(64-(j+1)B)); shape (n_in, l, n_out+1)."""
    n_in = sk_in.shape[0]
    n_out = sk_out.shape[0]
    out = np.empty((n_in, levels, n_out + 1), dtype=np.uint64)
    for i in range(n_in):
        for j in range(levels):
            msg = sk_in[i] << U64(_Q_LOG - (j + 1) * base_log)
            out[i, j] = lwe_encrypt(rng, sk_out, msg, std)
    return out


def keyswitch(ct: np.ndarray, ksk: np.ndarray, base_log: int,
              levels: int) -> np.ndarray:
    """LWE keyswitch: out = (0.., b) - sum_{i,j} Decomp_j(a_i) * KSK[i][j]."""
    n_in = ct.shape[-1] - 1
    n_out = ksk.shape[-1] - 1
    a, b = ct[..., :n_in], ct[..., n_in]
    digits = decompose(a, base_log, levels)            # (..., n_in, l) int64
    out = lwe_trivial(b, n_out)
    # signed digits as wrapped u64: products/sums mod 2^64 are exact
    acc = np.einsum("...il,ilm->...m", digits.astype(np.uint64),
                    ksk, dtype=np.uint64)
    return out - acc


# ---------------------------------------------------------------------------
# Key generation and the full PBS
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SecretKeys:
    """Client secret keys: small LWE key, GLWE key, and the flattened big key."""
    lwe_small: np.ndarray   # (n_small,)
    glwe: np.ndarray        # (k, N)

    @property
    def lwe_big(self) -> np.ndarray:
        return self.glwe.reshape(-1)


@dataclasses.dataclass
class ServerKeys:
    """Evaluation keys: bootstrap key (GGSW of small-key bits under the GLWE
    key) and keyswitch key (big key -> small key)."""
    bsk: np.ndarray         # (n_small, l, k+1, k+1, N)
    ksk: np.ndarray         # (n_big, ks_l, n_small+1)


def keygen(rng: np.random.Generator, params: CryptoParams
           ) -> tuple[SecretKeys, ServerKeys]:
    sk_small = sample_binary_key(rng, (params.n_small,))
    gsk = sample_binary_key(rng, (params.glwe_dimension, params.polynomial_size))
    sk = SecretKeys(lwe_small=sk_small, glwe=gsk)
    bsk = np.stack([
        ggsw_encrypt(rng, gsk, int(sk_small[i]), params.pbs_base_log,
                     params.pbs_level, params.glwe_std)
        for i in range(params.n_small)])
    ksk = keyswitch_keygen(rng, sk.lwe_big, sk_small, params.ks_base_log,
                           params.ks_level, params.lwe_std)
    return sk, ServerKeys(bsk=bsk, ksk=ksk)


def pbs(lwe_ct_big: np.ndarray, server_keys: ServerKeys, lut: np.ndarray,
        params: CryptoParams, message_bits: int,
        signed: bool = False) -> np.ndarray:
    """Full programmable bootstrap (KS -> modswitch -> BR -> sample extract).

    Input: LWE under the big key; output: LWE under the big key, encrypting
    lut[decode(input)] with fresh blind-rotate noise.  For signed inputs the
    phase is shifted by +2^(p-1) (a quarter-torus plaintext add) so the padding
    bit is cleared, and the LUT is half-rotated to compensate — reference
    FHEToTFHEScalar.cpp:395-411 + wrappers.cpp:409-421.
    """
    if signed:
        lwe_ct_big = lwe_ct_big.copy()
        lwe_ct_big[..., -1] += encode(1 << (message_bits - 1), message_bits)
    ct_small = keyswitch(lwe_ct_big, server_keys.ksk, params.ks_base_log,
                         params.ks_level)
    lut_poly = encode_expand_lut(lut, params.polynomial_size, message_bits,
                                 signed)
    acc = blind_rotate(ct_small, server_keys.bsk, lut_poly, params)
    return sample_extract(acc, 0)
