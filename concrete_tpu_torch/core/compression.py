"""Seeded ciphertext compression.

Reference: Compression::SEED in lib/Common/Transformers.cpp:224-260 and
concrete-cpu's seeded encryption (c_api/encrypt.rs concrete_cpu_init_seeded_*):
a fresh LWE ciphertext is stored as (seed, body) only — the mask is
regenerated from the seed on decompression, shrinking a (n+1)-word
ciphertext to 1 word + 16-byte seed (~n/1 compression for n in the
thousands).

The mask PRG is our ChaCha20 stream (utils/csprng.py), keyed by the seed:
compression/decompression are deterministic given (seed, index).

A copy of ``concrete_tpu/core/compression.py`` on the port's ChaCha20
stream (the same C source): the same seed gives the same masks, bodies and
expanded keys in both packages.  All of it is host numpy; a server
decompresses a seeded argument before uploading it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from concrete_tpu_torch.utils.csprng import ChaCha20Stream


@dataclasses.dataclass
class SeededLweCiphertext:
    """Batch of seeded LWE ciphertexts: bodies (..., 1) + one seed."""
    seed: bytes
    bodies: np.ndarray       # (...,) u64
    n: int                   # mask dimension

    @property
    def size_bytes(self) -> int:
        return len(self.seed) + self.bodies.nbytes


def encrypt_seeded(rng_noise, sk: np.ndarray, m_torus, std: float,
                   seed: bytes) -> SeededLweCiphertext:
    """Encrypt with a PRG-derived mask; only bodies are stored.

    rng_noise: numpy Generator (or SecureGenerator) for the gaussian noise.
    """
    from concrete_tpu_torch.core.refimpl import sample_torus_gaussian
    m_torus = np.asarray(m_torus, dtype=np.uint64)
    n = sk.shape[0]
    stream = ChaCha20Stream(seed=seed)
    count = int(np.prod(m_torus.shape)) if m_torus.shape else 1
    a = stream.random_u64((count, n))
    e = sample_torus_gaussian(rng_noise, std, m_torus.shape)
    body = ((a * sk).sum(axis=-1, dtype=np.uint64).reshape(m_torus.shape)
            + m_torus + e)
    return SeededLweCiphertext(seed=seed, bodies=body, n=n)


def decompress(ct: SeededLweCiphertext) -> np.ndarray:
    """Expand back to full (..., n+1) ciphertexts (same PRG stream)."""
    stream = ChaCha20Stream(seed=ct.seed)
    count = int(np.prod(ct.bodies.shape)) if ct.bodies.shape else 1
    a = stream.random_u64((count, ct.n)).reshape(ct.bodies.shape + (ct.n,))
    return np.concatenate([a, ct.bodies[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# Seeded evaluation keys (reference concrete_cpu_init_seeded_* + the
# compress_evaluation_keys configuration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SeededServerKeys:
    """BSK/KSK stored as PRG seed + body coefficients only.

    The GLWE masks of every BSK row and the LWE masks of every KSK row are
    regenerated from the seed on expansion — a (k+1)x / (n+1)x size
    reduction for transport/storage.
    """
    seed: bytes
    bsk_bodies: np.ndarray   # (n, l, k+1, N) u64
    ksk_bodies: np.ndarray   # (n_big, ks_l) u64
    n_small: int
    glwe_dimension: int
    polynomial_size: int
    pbs_level: int
    ks_level: int

    @property
    def size_bytes(self) -> int:
        return (len(self.seed) + self.bsk_bodies.nbytes
                + self.ksk_bodies.nbytes)

    def expand(self):
        """Regenerate the full ServerKeys (masks from the PRG stream).

        Mask draw order: all BSK row masks first, then all KSK masks —
        mirrors seeded generation in core/keygen.keygen_seeded.
        """
        from concrete_tpu_torch.core.refimpl import ServerKeys
        n, l, kp1, big_n = self.bsk_bodies.shape
        k = kp1 - 1
        stream = ChaCha20Stream(seed=self.seed)
        bsk_masks = stream.random_u64((n, l, kp1, k, big_n))
        bsk = np.concatenate([bsk_masks, self.bsk_bodies[..., None, :]],
                             axis=-2)
        n_big, ks_l = self.ksk_bodies.shape
        ksk_masks = stream.random_u64((n_big, ks_l, self.n_small))
        ksk = np.concatenate([ksk_masks, self.ksk_bodies[..., None]], axis=-1)
        return ServerKeys(bsk=bsk, ksk=ksk)
