"""Host side of the CRT-NTT blind rotate: primes, roots, tables.

The port's copy of what the fused path needs from the JAX package's
``concrete_tpu/core/ntt.py`` (``_primitive_root``, the psi idea of
``psi_tables``) and ``concrete_tpu/ops/pallas_fused_ntt.py``
(``_is_prime``, ``special_ntt_primes``, ``required_bits``,
``choose_fused_primes``, ``truncate_bsk_u64`` and the explicit-CRT
constants of ``_garner_shift_tables``).  The primes must be the JAX
package's: in the acc32 accumulator mode the blind rotate's output depends
on H = (prod p - 1) / 2, and so on the primes themselves.

What differs is the table layout.  The JAX kernel runs a four-step
transform as int8 matmuls; the port's kernels (``csrc/ntt.cuh``,
``csrc/ntt_regs.cuh``) run a radix-2 negacyclic NTT, its stages in
registers: Cooley-Tukey forward with the psi
twists merged into the twiddles (output in bit-reversed order),
Gentleman-Sande inverse (bit-reversed in, natural order out).  The tables
here are those twiddles, in the order the butterflies read them, with
their Shoup companions floor(w * 2^32 / p).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

#: polynomial sizes the fused path supports (the JAX optimizer's
#: FUSED_NTT_MAX_POLY_SIZE bounds the top; its kernel needs N/128 >= 8)
MIN_POLY_SIZE = 1024
MAX_POLY_SIZE = 16384
#: the smallest N at which the WoP vertical packing's runtime external
#: product (kernel 2's pack entry, kernel 3's keyed entry) runs
RUNTIME_MIN_POLY_SIZE = 256


def _is_prime(n: int) -> bool:
    if n < 2 or n % 2 == 0:
        return n == 2
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):  # exact < 3e24
        if a % n == 0:          # n is this witness itself
            continue
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _primitive_root(p: int) -> int:
    """Smallest generator of (Z/p)^*: the JAX package's choice, so psi and
    with it every spectrum agree between the two packages."""
    factors = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise ValueError("no primitive root")


def required_bits(params, trunc_bits: int) -> int:
    """Exact-CRT range for the external product with a t-bit-truncated BSK:
    |sum_cin sum_poly digit * (bsk >> t)| <= Cin * N * 2^(base_log-1) *
    2^(63-t); +1 for sign, +1 safety (which keeps |z| <= P/4)."""
    cin = params.pbs_level * (params.glwe_dimension + 1)
    return ((64 - trunc_bits) + (params.pbs_base_log - 1)
            + (params.polynomial_size * cin).bit_length() + 2)


def runtime_required_bits(n: int, kp1: int, base_log: int,
                          levels: int) -> int:
    """``required_bits`` for the external product with a runtime GGSW (a
    circuit bootstrap's output: full u64 entries, no truncation) at the
    cbs gadget: |z| <= Cin * N * 2^(base_log-1) * 2^63, Cin = levels *
    (k+1); +1 for sign, +1 safety."""
    return 64 + (base_log - 1) + (n * levels * kp1).bit_length() + 2


def runtime_primes(n: int, kp1: int, base_log: int, levels: int) -> tuple:
    """The fewest special-form primes whose product covers
    ``runtime_required_bits`` (log2(prod) >= the bits, as
    ``choose_fused_primes`` counts at t = 0): 3 at PIR 32's vertical
    packing (N=4096, k+1=2, cbs 3 x 2^5: 85 bits)."""
    need = runtime_required_bits(n, kp1, base_log, levels)
    pool = special_ntt_primes(n, 128)
    for count in range(2, len(pool) + 1):
        if math.prod(pool[:count]).bit_length() - 1 >= need:
            return tuple(pool[:count])
    raise ValueError(f"no {len(pool)}-prime product covers {need} bits")


@functools.lru_cache(maxsize=None)
def special_ntt_primes(n: int, min_total_bits: int) -> tuple:
    """NTT primes of the special form p = 2^31 - d*m + 1 with
    m = max(2N, 2^14), so 2N | p-1, in the JAX package's order."""
    m = max(2 * n, 1 << 14)
    d_max = (1 << 21) // m
    assert d_max >= 8, f"N={n} too large for the special prime family"
    out, total_bits = [], 0
    for d in range(1, d_max + 1):
        p = (1 << 31) - d * m + 1
        if _is_prime(p):
            out.append(p)
            total_bits += 31
            if total_bits >= min_total_bits + 31:
                break
    return tuple(out)


def choose_fused_primes(params, message_bits: int = None,
                        norm2: float = 1) -> tuple[tuple, int]:
    """(primes, trunc_bits): the fewest special-form primes whose range
    covers the external product after a noise-budget-validated BSK
    truncation (the JAX package's rule, unchanged)."""
    from concrete_tpu_torch import params as pp
    pool = special_ntt_primes(params.polynomial_size, 128)
    req0 = required_bits(params, 0)
    for count in range(2, len(pool) + 1):
        ps = pool[:count]
        cap = (math.prod(ps)).bit_length() - 1
        t = max(0, req0 - cap)
        if t == 0:
            return tuple(ps), 0
        if t >= 48:
            continue
        added = pp.variance_bsk_truncation_bits(
            params.n_small, params.glwe_dimension, params.polynomial_size,
            params.pbs_base_log, params.pbs_level, t,
            params.q_log) * float(norm2) ** 2
        if message_bits is not None:
            budget = pp.safe_variance_bound(message_bits, 6.3e-5) * 0.05
        else:
            budget = 0.01 * pp.variance_blind_rotate(
                params.n_small, params.glwe_dimension,
                params.polynomial_size, params.pbs_base_log,
                params.pbs_level, params.glwe_std ** 2, params.q_log)
        if added <= budget:
            return tuple(ps), t
    return tuple(pool), max(0, req0 - (math.prod(pool).bit_length() - 1))


def truncate_bsk_u64(bsk_u64: np.ndarray, trunc_bits: int) -> np.ndarray:
    """Zero the low t bits of every BSK coefficient (the oracle's key)."""
    if trunc_bits == 0:
        return np.asarray(bsk_u64)
    b = np.asarray(bsk_u64, dtype=np.uint64)
    return (b >> np.uint64(trunc_bits)) << np.uint64(trunc_bits)


def digits_lo_free(base_log: int, levels: int) -> bool:
    """The gadget digits read only the accumulator's top u32 word."""
    return levels * base_log <= 31


def bit_reverse(n: int) -> np.ndarray:
    """i -> bitrev(i) over log2(n) bits: the forward transform's output
    position i holds the natural frequency bit_reverse(n)[i]."""
    bits = n.bit_length() - 1
    i = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def check_poly_size(n: int) -> None:
    if n & (n - 1) or not MIN_POLY_SIZE <= n <= MAX_POLY_SIZE:
        raise ValueError(f"the CRT-NTT path supports N in {MIN_POLY_SIZE}.."
                         f"{MAX_POLY_SIZE} (powers of two), got N={n}")


@functools.lru_cache(maxsize=None)
def twiddle_tables(n: int, primes: tuple) -> np.ndarray:
    """(P, 4, N) u32: per prime, the forward twiddles psi^bitrev(i), their
    Shoup companions, the inverse twiddles psi^-bitrev(i), theirs.  psi is
    the JAX package's primitive 2N-th root g^((p-1)/2N)."""
    rev = bit_reverse(n)
    out = np.empty((len(primes), 4, n), dtype=np.uint32)
    for pi, p in enumerate(primes):
        if p >= 1 << 31 or (p - 1) % (2 * n) or not _is_prime(p):
            raise ValueError(f"{p} is not a prime < 2^31 with 2N | p-1")
        g = _primitive_root(p)
        psi = pow(g, (p - 1) // (2 * n), p)
        assert pow(psi, n, p) == p - 1
        pw = np.empty(n, dtype=np.uint64)
        ipw = np.empty(n, dtype=np.uint64)
        x, y, psi_inv = 1, 1, pow(psi, -1, p)
        for i in range(n):
            pw[i], ipw[i] = x, y
            x, y = x * psi % p, y * psi_inv % p
        fwd, inv = pw[rev], ipw[rev]
        out[pi, 0], out[pi, 2] = fwd, inv
        out[pi, 1] = (fwd << np.uint64(32)) // np.uint64(p)
        out[pi, 3] = (inv << np.uint64(32)) // np.uint64(p)
    return out


def prime_constants(n: int, primes: tuple) -> np.ndarray:
    """(P, 3) u32: p, N^-1 mod p, and its Shoup companion."""
    rows = []
    for p in primes:
        n_inv = pow(n, -1, p)
        rows.append((p, n_inv, (n_inv << 32) // p))
    return np.array(rows, dtype=np.uint64).astype(np.uint32)


def forward_constants(n: int, primes: tuple) -> np.ndarray:
    """(P, 8) u32, the constants kernel 2 (``csrc/ntt.cu``) reads per prime:
    p, N^-1 mod p and its Shoup companion (``prime_constants``); 2^32 mod p
    and its companion, for the high word of a signed 64-bit input;
    floor(2^64 / p) as its high word floor(2^32 / p) (also the companion of
    1, for the low word) and its low word, for the companions of the key
    pack; 2^64 mod p, taken off a negative input's residue."""
    rows = []
    for (p, n_inv, n_inv_sh) in prime_constants(n, primes).tolist():
        c32 = (1 << 32) % p
        recip = (1 << 64) // p
        rows.append((p, n_inv, n_inv_sh, c32, (c32 << 32) // p, recip >> 32,
                     recip & 0xFFFFFFFF, (1 << 64) % p))
    return np.array(rows, dtype=np.uint64).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class GarnerConstants:
    """Explicit-CRT recombination of residues r_i of a signed z, |z| <= P/4:
    c_i = (r_i + H) * M_i^-1 mod p_i = r_i * inv_i + hinv_i (mod p_i),
    w = z + H = sum_i c_i M_i - k P with k = floor(sum_i c_i / p_i),
    all mod 2^64; H = (P - 1) / 2, M_i = P / p_i."""
    primes: tuple
    inv: tuple          # M_i^-1 mod p_i
    inv_sh: tuple       # floor(inv_i * 2^32 / p_i)
    hinv: tuple         # H * M_i^-1 mod p_i
    m64: tuple          # M_i mod 2^64
    p64: int            # P mod 2^64
    h64: int            # H mod 2^64


@functools.lru_cache(maxsize=None)
def garner_constants(primes: tuple) -> GarnerConstants:
    p_prod = math.prod(primes)
    h_half = (p_prod - 1) // 2
    inv, inv_sh, hinv, m64 = [], [], [], []
    for p in primes:
        m_i = p_prod // p
        v = pow(m_i % p, -1, p)
        inv.append(v)
        inv_sh.append((v << 32) // p)
        hinv.append(h_half * v % p)
        m64.append(m_i % (1 << 64))
    return GarnerConstants(primes=tuple(primes), inv=tuple(inv),
                           inv_sh=tuple(inv_sh), hinv=tuple(hinv),
                           m64=tuple(m64), p64=p_prod % (1 << 64),
                           h64=h_half % (1 << 64))


def h_top(primes: tuple, trunc_bits: int) -> int:
    """top32((H << t) mod 2^64): what the acc32 mode subtracts per step."""
    h_half = (math.prod(primes) - 1) // 2
    return ((h_half << trunc_bits) % (1 << 64)) >> 32
