"""Key generation for real-size parameters — host-only numpy.

A copy of ``concrete_tpu/core/keygen.py`` without ``keygen_seeded`` (seeded
key compression is not ported yet): the same seed gives the same keys in
both packages.

Functionally identical to refimpl.keygen (which stays the oracle for tiny
parameters) but vectorized: the GLWE body polynomials  sum_r A_r (*) S_r  are
exact BLAS f64 matmuls over 16-bit mask limbs against the binary key's
negacyclic Toeplitz matrix (see _negacyclic_dot_with_key), so generating a
production BSK (~n * l * (k+1) GLWE rows) takes seconds on the host with no
device compile — keyset generation no longer touches the TPU at all.

Reference analog: lib/Common/Keys.cpp:59,115,239 (concrete-cpu keygen calls,
with rayon parallelism); here the batch axis is the vector axis.

Randomness: the functions take any numpy-Generator-compatible source; the
production path (compilation/keys.py Keys.generate) passes the ChaCha20
SecureGenerator (concrete_tpu/utils/csprng.py; reference: concrete-cpu
c_api/csprng.rs).  numpy Generators appear only in tests/oracles.
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.core.refimpl import (SecretKeys, ServerKeys,
                                       sample_binary_key,
                                       sample_torus_gaussian,
                                       sample_uniform_u64)
from concrete_tpu_torch.params import CryptoParams


def _negacyclic_dot_with_key(a_polys: np.ndarray, key: np.ndarray) -> np.ndarray:
    """sum_r a_polys[..., r, :] (*) key[r, :]  mod 2^64, exactly — jit-free.

    a_polys: (rows, k, N) u64; key: (k, N) binary u64.

    Host-side exact path: the binary key's negacyclic Toeplitz matrix has
    entries in {-1, 0, 1}, so splitting the u64 masks into four 16-bit limbs
    makes every BLAS f64 matmul exact (|partial sums| <= N * 2^16 << 2^53),
    and the limb recombination wraps mod 2^64 in u64.  This keeps keygen
    off the device entirely — no jit, no compile latency (the device keygen
    graph used to dominate keyset generation time).
    """
    rows, k, n = a_polys.shape
    j = np.arange(n)
    # M[t, j] = key[(j - t) mod n] with a sign flip where j < t (negacyclic)
    idx = (j[None, :] - j[:, None]) % n
    sign = np.where(j[None, :] >= j[:, None], 1.0, -1.0)
    out = np.zeros((rows, n), dtype=np.uint64)
    for r in range(k):
        m = key[r].astype(np.float64)[idx] * sign          # (N, N) in {-1,0,1}
        a_r = a_polys[:, r, :]
        for i in range(4):
            limb = ((a_r >> np.uint64(16 * i))
                    & np.uint64(0xFFFF)).astype(np.float64)
            c = limb @ m                                   # exact in f64
            out += c.astype(np.int64).astype(np.uint64) << np.uint64(16 * i)
    return out


def glwe_encrypt_batch(rng: np.random.Generator, gsk: np.ndarray,
                       m_polys: np.ndarray, std: float) -> np.ndarray:
    """Batched GLWE encryption: m_polys (rows, N) -> (rows, k+1, N)."""
    k, n = gsk.shape
    rows = m_polys.shape[0]
    a = sample_uniform_u64(rng, (rows, k, n))
    e = sample_torus_gaussian(rng, std, (rows, n))
    body = _negacyclic_dot_with_key(a, gsk) + m_polys + e
    return np.concatenate([a, body[:, None, :]], axis=1)


def make_bsk(rng: np.random.Generator, sk_small: np.ndarray, gsk: np.ndarray,
             params: CryptoParams) -> np.ndarray:
    """Bootstrap key: GGSW(s_i) for each small-key bit, (n, l, k+1, k+1, N)."""
    n_small = params.n_small
    k, n = gsk.shape
    l = params.pbs_level
    # message polys for every (i, level j, row r): r<k: -s_i*S_r*g_j; r=k: s_i*g_j
    msgs = np.zeros((n_small, l, k + 1, n), dtype=np.uint64)
    for j in range(l):
        g = np.uint64(1) << np.uint64(64 - (j + 1) * params.pbs_base_log)
        for r in range(k):
            msgs[:, j, r, :] = ((-(sk_small[:, None].astype(np.int64))
                                 * gsk[r].astype(np.int64)).astype(np.uint64)
                                * g)
        msgs[:, j, k, 0] = sk_small * g
    flat = msgs.reshape(n_small * l * (k + 1), n)
    cts = glwe_encrypt_batch(rng, gsk, flat, params.glwe_std)
    return cts.reshape(n_small, l, k + 1, k + 1, n)


def make_ksk(rng: np.random.Generator, sk_in: np.ndarray, sk_out: np.ndarray,
             base_log: int, levels: int, std: float) -> np.ndarray:
    """Keyswitch key (n_in, l, n_out+1), batched LWE encryptions."""
    n_in = sk_in.shape[0]
    n_out = sk_out.shape[0]
    g = (np.uint64(1) << (np.uint64(64) - np.uint64(base_log)
                          * np.arange(1, levels + 1, dtype=np.uint64)))
    msgs = sk_in[:, None] * g[None, :]                        # (n_in, l)
    a = sample_uniform_u64(rng, (n_in, levels, n_out))
    e = sample_torus_gaussian(rng, std, (n_in, levels))
    body = (a * sk_out).sum(axis=-1, dtype=np.uint64) + msgs + e
    return np.concatenate([a, body[..., None]], axis=-1)


def keygen(rng: np.random.Generator, params: CryptoParams,
           glwe_key: np.ndarray = None) -> tuple[SecretKeys, ServerKeys]:
    """Full (client, server) key generation; fast path for real parameters.

    `glwe_key` injects an externally shared big/GLWE secret key (TFHE-rs
    interop, reference bridge.py:237 keygen_with_initial_keys): the BSK and
    KSK are then generated *from* that key, so ciphertexts imported under it
    bootstrap correctly.
    """
    sk_small = sample_binary_key(rng, (params.n_small,))
    if glwe_key is None:
        gsk = sample_binary_key(
            rng, (params.glwe_dimension, params.polynomial_size))
    else:
        gsk = np.asarray(glwe_key, dtype=np.uint64).reshape(
            params.glwe_dimension, params.polynomial_size)
    sk = SecretKeys(lwe_small=sk_small, glwe=gsk)
    bsk = make_bsk(rng, sk_small, gsk, params)
    ksk = make_ksk(rng, sk.lwe_big, sk_small, params.ks_base_log,
                   params.ks_level, params.lwe_std)
    return sk, ServerKeys(bsk=bsk, ksk=ksk)


def encrypt_lwe_batch(rng: np.random.Generator, sk_flat: np.ndarray,
                      m_torus: np.ndarray, std: float) -> np.ndarray:
    """Batched LWE encryption under a flat key: (B,) torus -> (B, n+1)."""
    n = sk_flat.shape[0]
    m_torus = np.asarray(m_torus, dtype=np.uint64)
    a = sample_uniform_u64(rng, m_torus.shape + (n,))
    e = sample_torus_gaussian(rng, std, m_torus.shape)
    body = (a * sk_flat).sum(axis=-1, dtype=np.uint64) + m_torus + e
    return np.concatenate([a, body[..., None]], axis=-1)
