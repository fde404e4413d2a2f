"""WoP-PBS (without-padding programmable bootstrap) — numpy oracle.

A copy of ``concrete_tpu/core/wop.py`` with the port's imports: the
parameters (``WopParams``), the PFPKSK key generation (``pfpksk_gen``),
the CRT tables and the oracle the port's ``core/kernels_wop.py`` is held
to.

The large-precision TLU path: bit extraction + circuit bootstrap +
vertical packing, enabling table lookups on >8-bit (and CRT-packed) values
that a single blind rotate cannot index.

Reference behavior matched (implementation is original, built on
core/refimpl.py primitives):
  - compiler/lib/Runtime/wrappers.cpp:855-998 (wop_pbs_crt path)
  - backends/concrete-cpu/implementation/src/c_api/wop_pbs.rs (extract_bits,
    circuit_bootstrap_boolean_vertical_packing)
  - PFPKSK keygen: compiler/lib/Common/Keys.cpp:365

Pipeline for a p-bit TLU (p can exceed log2(N)):
  1. `extract_bits`: peel the p message bits of an LWE ciphertext into p
     LWE ciphertexts each encrypting one bit at scale 2^63 (LSB-first
     internally; returned MSB-first for vertical packing).  Per bit: shift,
     sign-PBS to clean, subtract, continue.
  2. `circuit_bootstrap`: bit-LWE -> GGSW via one sign-PBS per gadget level
     (bit at scale 2^(64-(j+1)B)) + one private functional packing
     keyswitch per GLWE row (multiplying by -S_r, or 1 for the body row).
  3. `vertical_packing`: the 2^p-entry LUT is split into 2^p/N polynomial
     chunks; a CMUX tree over the high GGSW bits selects the chunk, then a
     GGSW-driven blind rotation over the low log2(N) bits selects the
     coefficient; sample-extract coefficient 0.

All functions operate on exact u64 torus arithmetic like refimpl — this
module is the correctness oracle for the batched kernels
(``core/kernels_wop.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.params import CryptoParams

U64 = np.uint64
_Q_LOG = 64


# ---------------------------------------------------------------------------
# Parameters + keys
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WopParams:
    """WoP-PBS gadget parameters on top of the base CryptoParams.

    cbs_*: circuit-bootstrap output GGSW gadget (levels of the GGSW the
    vertical-packing CMUXes consume).  pfks_*: private functional packing
    keyswitch gadget.  Reference: wop_pbs.rs parameter plumbing.
    """
    base: CryptoParams
    cbs_level: int = 3
    cbs_base_log: int = 6
    pfks_level: int = 8
    pfks_base_log: int = 4


@dataclasses.dataclass
class WopKeys:
    """PFPKSK bundle: pfpksk[r] packs an LWE (big key) into a GLWE whose
    message is multiplied by v_r = -S_r (r < k) or +1 (r = k).

    Shape: (k+1, n_big+1, pfks_level, k+1, N).
    """
    pfpksk: np.ndarray


def pfpksk_gen(rng: np.random.Generator, sk: ref.SecretKeys,
               wp: WopParams) -> WopKeys:
    """Generate the private functional packing keyswitch keys.

    Reference: Keys.cpp:365 (PackingKeyswitchKey generation over the
    big-LWE -> GLWE pair with the -S_r secret functions).  Batched through
    core.keygen.glwe_encrypt_batch (banded-matmul body computation) — the
    key has (k+1)*(n_big+1)*levels GLWE rows.
    """
    from concrete_tpu_torch.core import keygen as kg
    params = wp.base
    k, n = sk.glwe.shape
    n_big = params.n_big
    sk_big = sk.lwe_big.astype(np.int64)
    levels, base_log = wp.pfks_level, wp.pfks_base_log
    # v_r(X): -S_r for r < k, +1 for r = k
    v_polys = np.zeros((k + 1, n), dtype=np.int64)
    v_polys[:k] = -sk.glwe.astype(np.int64)
    v_polys[k, 0] = 1
    # coefficients: in_coeffs[i] = -sk_big[i] for masks, +1 for the body
    in_coeffs = np.concatenate([-sk_big, [1]])           # (n_big+1,)
    g = (U64(1) << (U64(_Q_LOG)
                    - U64(base_log) * np.arange(1, levels + 1,
                                                dtype=np.uint64)))
    msgs = (in_coeffs[None, :, None, None].astype(np.uint64)
            * v_polys[:, None, None, :].astype(np.uint64)
            * g[None, None, :, None])   # (k+1, n_big+1, levels, N)
    flat = msgs.reshape(-1, n)
    cts = kg.glwe_encrypt_batch(rng, sk.glwe, flat, params.glwe_std)
    return WopKeys(pfpksk=cts.reshape(k + 1, n_big + 1, levels, k + 1, n))


def pfpksk_gen_device(rng, sk: ref.SecretKeys, wp: WopParams, device,
                      timings: dict = None):
    """``pfpksk_gen`` with the bodies' product on `device`
    (``core.keygen.glwe_encrypt_batch_device``): the (k+1, n_big+1, levels,
    k+1, N) int64 PFPKSK there, bit for bit the host's from the same
    generator.  Row ((r (n_big+1) + i) levels + j) encrypts in_coeffs[i]
    v_r g_j; the messages are made on the device a chunk at a time (4.3 GB
    at PIR over 64 rows, never whole)."""
    import torch

    from concrete_tpu_torch.core import keygen as kg
    device = torch.device(device)
    params = wp.base
    k, n = sk.glwe.shape
    n_in = params.n_big + 1
    levels = wp.pfks_level
    gsk = torch.from_numpy(np.asarray(sk.glwe, dtype=np.int64)).to(device)
    e0 = torch.zeros((1, n), dtype=torch.int64, device=device)
    e0[0, 0] = 1
    v_polys = torch.cat([-gsk, e0])                      # (k+1, N)
    in_coeffs = torch.cat([-torch.from_numpy(np.asarray(
        sk.lwe_big, dtype=np.int64)), torch.ones(1, dtype=torch.int64)]
    ).to(device)                                         # (n_big+1,)
    g = kg.gadget_i64(wp.pfks_base_log, levels).to(device)

    def messages(r0, r1):
        q = torch.arange(r0, r1, device=device)
        r, i, j = q // (n_in * levels), (q // levels) % n_in, q % levels
        return (in_coeffs[i] * g[j])[:, None] * v_polys[r]

    rows = (k + 1) * n_in * levels
    cts = kg.glwe_encrypt_batch_device(rng, sk.glwe, rows, messages,
                                       params.glwe_std, device,
                                       timings=timings)
    return cts.view(k + 1, n_in, levels, k + 1, n)


def private_packing_keyswitch(lwe_ct: np.ndarray, pfpksk_r: np.ndarray,
                              base_log: int, levels: int) -> np.ndarray:
    """One LWE (big key) -> GLWE with the message multiplied by the key's
    secret function v_r.  out = sum_i Decomp(a_i) * K[i] + Decomp(b) * K[n].
    """
    digits = ref.decompose(lwe_ct, base_log, levels)     # (n_big+1, l)
    return np.einsum("il,ilcn->cn", digits.astype(np.uint64), pfpksk_r,
                     dtype=np.uint64)


# ---------------------------------------------------------------------------
# Sign PBS (the "without padding" bootstrap on one bit position)
# ---------------------------------------------------------------------------

def _sign_pbs(lwe_big: np.ndarray, server: ref.ServerKeys,
              params: CryptoParams, out_scale_log: int) -> np.ndarray:
    """LWE(b * 2^63 + small) -> LWE(b * 2^out_scale_log) exactly.

    Test polynomial is the constant -2^(out-1): blind rotation gives
    (1-2b) * (-2^(out-1)) = b*2^out - 2^(out-1); the half is added back as
    a plaintext constant.  Works without a padding bit (wrappers.cpp:872
    style bit cleaning).

    A quarter-torus offset (+2^62) is added first: b*2^63 sits exactly on
    the half-torus boundary for BOTH bit values, so without the offset any
    noise flips the sign; centered, each bit rests mid-half (the
    reference's bit-extract applies the same plaintext shift).
    """
    lwe_big = np.array(lwe_big, dtype=np.uint64)
    lwe_big[..., -1] += U64(1) << U64(62)
    ct_small = ref.keyswitch(lwe_big, server.ksk, params.ks_base_log,
                             params.ks_level)
    half = U64(1) << U64(out_scale_log - 1)
    test_poly = np.full(params.polynomial_size, U64(0) - half, dtype=np.uint64)
    acc = ref.blind_rotate(ct_small, server.bsk, test_poly, params)
    out = ref.sample_extract(acc, 0)
    out[..., -1] += half
    return out


# ---------------------------------------------------------------------------
# 1. Bit extraction
# ---------------------------------------------------------------------------

def extract_bits(lwe_big: np.ndarray, nb_bits: int, delta_log: int,
                 server: ref.ServerKeys, params: CryptoParams) -> np.ndarray:
    """Extract `nb_bits` bits of the message m (at scale 2^delta_log).

    Returns (nb_bits, n_big+1) with row 0 = MSB (vertical-packing order),
    each encrypting bit * 2^63.  LSB-first internally: the extracted bit is
    cleaned by a sign-PBS at its own scale and subtracted before moving up,
    so lower positions never pollute later shifts (wop_pbs.rs
    extract_bits).
    """
    n_big = params.n_big
    acc = np.array(lwe_big, dtype=np.uint64)
    bits = np.empty((nb_bits, n_big + 1), dtype=np.uint64)
    for i in range(nb_bits):
        pos = delta_log + i
        shift = U64(_Q_LOG - 1 - pos)
        shifted = acc * (U64(1) << shift)         # bit i now at position 63
        bits[nb_bits - 1 - i] = _sign_pbs(shifted, server, params, 63)
        if i < nb_bits - 1:
            # clean the bit at its own scale and remove it from acc
            cleaned = _sign_pbs(shifted, server, params, pos)
            acc = acc - cleaned
    return bits


# ---------------------------------------------------------------------------
# 2. Circuit bootstrap: bit LWE -> GGSW
# ---------------------------------------------------------------------------

def circuit_bootstrap(bit_lwe: np.ndarray, server: ref.ServerKeys,
                      wop_keys: WopKeys, wp: WopParams) -> np.ndarray:
    """LWE(b * 2^63) -> GGSW(b) with the cbs gadget.

    For each level j: sign-PBS the bit to scale 2^(64-(j+1)B), then pack
    into each GLWE row via the r-th PFPKSK (message multiplied by -S_r / 1).
    Reference: wrappers.cpp circuit bootstrap + wop_pbs.rs.
    """
    params = wp.base
    k = params.glwe_dimension
    n = params.polynomial_size
    levels, base_log = wp.cbs_level, wp.cbs_base_log
    ggsw = np.empty((levels, k + 1, k + 1, n), dtype=np.uint64)
    for j in range(levels):
        scale_log = _Q_LOG - (j + 1) * base_log
        lev_lwe = _sign_pbs(bit_lwe, server, params, scale_log)
        for r in range(k + 1):
            ggsw[j, r] = private_packing_keyswitch(
                lev_lwe, wop_keys.pfpksk[r], wp.pfks_base_log, wp.pfks_level)
    return ggsw


# ---------------------------------------------------------------------------
# 3. Vertical packing
# ---------------------------------------------------------------------------

def vertical_packing(lut: np.ndarray, ggsw_bits: np.ndarray,
                     wp: WopParams) -> np.ndarray:
    """LUT (2^nb u64 torus values) selected by nb GGSW bits (MSB first).

    High bits (nb - log2(N)) select the LUT chunk via a CMUX tree; the low
    log2(N) bits drive a GGSW blind rotation; coefficient 0 of the final
    accumulator is LWE(lut[m]) under the big key.  Reference:
    wop_pbs.rs circuit_bootstrap_boolean_vertical_packing.
    """
    params = wp.base
    n = params.polynomial_size
    k = params.glwe_dimension
    levels, base_log = wp.cbs_level, wp.cbs_base_log
    nb = ggsw_bits.shape[0]
    lut = np.asarray(lut, dtype=np.uint64)
    assert lut.shape[-1] == 1 << nb
    n_in_chunk = min(nb, int(np.log2(n)))
    n_tree = nb - n_in_chunk

    # chunk polynomials as trivial GLWEs
    chunks = lut.reshape(1 << n_tree, -1)
    layer = [ref.glwe_trivial(np.pad(c, (0, n - c.shape[0])), k)
             for c in chunks]
    # CMUX tree over the high bits: bit order MSB..; the LSB of the *tree*
    # bits distinguishes adjacent chunks, so reduce from that end
    for t in range(n_tree):
        bit = ggsw_bits[n_tree - 1 - t]          # tree LSB first
        layer = [ref.cmux(bit, layer[2 * u], layer[2 * u + 1],
                          base_log, levels)
                 for u in range(len(layer) // 2)]
    acc = layer[0]

    # GGSW blind rotation over the low bits: bit t has weight 2^t
    for t in range(n_in_chunk):
        bit = ggsw_bits[nb - 1 - t]              # low bits, LSB first
        rotated = np.stack([ref.monomial_mul(acc[c], 2 * n - (1 << t))
                            for c in range(k + 1)])
        acc = ref.cmux(bit, acc, rotated, base_log, levels)
    return ref.sample_extract(acc, 0)


# ---------------------------------------------------------------------------
# Full WoP-PBS
# ---------------------------------------------------------------------------

def crt_block_bits(moduli) -> tuple:
    """Bits extracted per CRT residue block: ceil(log2 m_j)
    (wrappers.cpp:907 number_of_bits_per_block)."""
    return tuple(int(np.ceil(np.log2(m))) for m in moduli)


def crt_lut_tables(table, moduli, out_moduli=None, bits=None) -> np.ndarray:
    """Vertical-packing tables for a TLU over a CRT value.

    Index layout matches the reference (wrappers.cpp:918-921 bit order +
    :575 out_index construction): block 0's bits are the LEAST significant
    of the combined index, block n-1's the most.  With native-encoded
    residues the per-block sub-index is the residue value itself (the
    reference's `(r << bits) / m` map at wrappers.cpp:577 compensates for
    its full-torus r*2^64/m CRT encoding, which we do not use).

    Returns (len(out_moduli), 2^total_bits) int64 raw entries:
    row j holds f(x) mod out_m_j at the index of every consistent residue
    combination; inconsistent/unreachable combinations hold 0
    (wrappers.cpp:483 zero-fill).

    `bits` overrides the per-block index widths (default ceil(log2 m_j)):
    the compiler passes the residues' actual encoding widths, which may be
    narrower when the measured input range never reaches m_j - 1 — residue
    combinations that don't fit are unreachable and skipped.
    """
    moduli = tuple(int(m) for m in moduli)
    out_moduli = tuple(int(m) for m in (out_moduli or moduli))
    bits = tuple(bits) if bits is not None else crt_block_bits(moduli)
    total = int(np.prod(moduli))
    table = np.asarray(table, dtype=np.int64)
    out = np.zeros((len(out_moduli), 1 << sum(bits)), dtype=np.int64)
    for x in range(min(total, len(table))):
        idx = 0
        offset = 0
        reachable = True
        for m, nb in zip(moduli, bits):
            r = x % m
            if r >= (1 << nb):
                reachable = False
                break
            idx |= r << offset
            offset += nb
        if not reachable:
            continue
        for j, m_out in enumerate(out_moduli):
            out[j, idx] = int(table[x]) % m_out
    return out


def wop_pbs_crt(res_lwes, table, moduli, server: ref.ServerKeys,
                wop_keys: WopKeys, wp: WopParams):
    """TLU over a CRT value: per-residue bit extraction, one shared circuit
    bootstrap, and one vertical packing per output residue.

    res_lwes: (n_blocks, n_big+1) LWEs, residue j native-encoded at
    ceil(log2 m_j) bits.  Returns (n_blocks, n_big+1) output residues of
    table[x] (native-encoded), x the CRT-decoded input.

    Reference behavior: memref_wop_pbs_crt_buffer (wrappers.cpp:855-998) —
    same bit order, shared extraction, per-output-block vertical packing;
    encoding differs as documented in crt_lut_tables.
    """
    params = wp.base
    bits = crt_block_bits(moduli)
    luts = crt_lut_tables(table, moduli)
    # block n-1 extracted first = most significant bits of the index
    all_bits = []
    for j in reversed(range(len(moduli))):
        delta_log = _Q_LOG - bits[j] - 1          # native encoding LSB
        all_bits.append(extract_bits(res_lwes[j], bits[j], delta_log,
                                     server, params))
    bit_stack = np.concatenate(all_bits, axis=0)   # (total_bits, n_big+1)
    ggsws = np.stack([circuit_bootstrap(b, server, wop_keys, wp)
                      for b in bit_stack])
    out = np.empty_like(np.asarray(res_lwes))
    for j, m_out in enumerate(moduli):
        out_bits_j = bits[j]
        lut_torus = (luts[j].astype(np.uint64)
                     & U64((1 << (out_bits_j + 1)) - 1)) \
            << U64(_Q_LOG - out_bits_j - 1)
        out[j] = vertical_packing(lut_torus, ggsws, wp)
    return out


def wop_pbs(lwe_big: np.ndarray, lut: np.ndarray, nb_bits: int,
            delta_log: int, out_bits: int, server: ref.ServerKeys,
            wop_keys: WopKeys, wp: WopParams) -> np.ndarray:
    """p-bit TLU via extract-bits -> circuit-bootstrap -> vertical packing.

    `lut` holds raw integer entries; the output is encoded at `out_bits`
    (value << (64 - out_bits - 1)), ready for further leveled arithmetic.
    """
    params = wp.base
    bits = extract_bits(lwe_big, nb_bits, delta_log, server, params)
    ggsws = np.stack([circuit_bootstrap(bits[i], server, wop_keys, wp)
                      for i in range(nb_bits)])
    lut_torus = (np.asarray(lut, dtype=np.uint64)
                 & U64((1 << (out_bits + 1)) - 1)) \
        << U64(_Q_LOG - out_bits - 1)
    return vertical_packing(lut_torus, ggsws, wp)
