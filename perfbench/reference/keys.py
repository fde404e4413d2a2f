"""The client's secret key, derived again from the run's seed, and decryption.

A frozen copy of the port's key draw, in plain NumPy, so that the
benchmark judges the program's output ciphertexts without taking any key
from the program:

- the ChaCha20 keystream of RFC 8439 (256-bit key, 96-bit nonce of zeros,
  32-bit block counter from 0), as ``utils/csprng.py`` and its
  ``csrc/chacha20.c`` make it;
- an integer seed becomes the 32-byte key little-endian (a negative one its
  SHA-256 of ``str(seed)``), as ``SecureGenerator`` does;
- a keyset draws the small LWE key's n_small bits first, then the GLWE
  key's k * N bits, each bit the low bit of one u64 word, and each draw
  starts at a fresh 64-byte block (``Keys.generate`` ->
  ``keygen_device`` -> ``sample_binary_key``);
- ciphertexts are encrypted under the big key, the GLWE key flattened.

Encoding: p message bits and one padding bit at the top of the u64 torus;
decoding rounds to the nearest step and folds the padding bit away.
"""

from __future__ import annotations

import hashlib

import numpy as np

_CONSTANTS = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574],
                      dtype=np.uint32)
_U64 = np.uint64


def _rotl(v: np.ndarray, c: int) -> np.ndarray:
    return (v << np.uint32(c)) | (v >> np.uint32(32 - c))


def _quarter(x, a, b, c, d) -> None:
    x[a] += x[b]; x[d] ^= x[a]; x[d] = _rotl(x[d], 16)
    x[c] += x[d]; x[b] ^= x[c]; x[b] = _rotl(x[b], 12)
    x[a] += x[b]; x[d] ^= x[a]; x[d] = _rotl(x[d], 8)
    x[c] += x[d]; x[b] ^= x[c]; x[b] = _rotl(x[b], 7)


def chacha20_blocks(key: bytes, nonce: bytes, counter: int,
                    blocks: int) -> bytes:
    """`blocks` 64-byte keystream blocks from block `counter` on."""
    state = np.empty((16, blocks), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = np.frombuffer(key, dtype="<u4")[:, None]
    state[12] = (counter + np.arange(blocks, dtype=np.uint64)).astype(
        np.uint32)
    state[13:16] = np.frombuffer(nonce, dtype="<u4")[:, None]
    x = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        x += state
    return x.T.astype("<u4").tobytes()


def seed_key(seed: int) -> bytes:
    if seed >= 0:
        return int(seed).to_bytes(32, "little", signed=False)
    return hashlib.sha256(str(seed).encode()).digest()


def big_secret_key(seed: int, n_small: int, glwe_dimension: int,
                   polynomial_size: int) -> np.ndarray:
    """The flattened GLWE key (k * N bits as u64) of the keyset that the
    port generates from `seed`."""
    key = seed_key(seed)
    skip = (8 * n_small + 63) // 64          # the small key's blocks
    words = glwe_dimension * polynomial_size
    stream = chacha20_blocks(key, b"\0" * 12, skip, (8 * words + 63) // 64)
    return np.frombuffer(stream[:8 * words], dtype="<u8").astype(
        np.uint64) & _U64(1)


def encode(message, bits: int) -> np.ndarray:
    return np.asarray(message, dtype=np.int64).astype(np.uint64) << _U64(
        64 - (bits + 1))


def decrypt(secret: np.ndarray, ct: np.ndarray) -> np.ndarray:
    """The phase b - <a, s> mod 2^64 of (..., n + 1) u64 ciphertexts."""
    ct = np.asarray(ct, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return ct[..., -1] - (ct[..., :-1] * secret).sum(axis=-1,
                                                         dtype=np.uint64)


def decode(phase: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    """Round a phase to the nearest of 2^(bits+1) steps, drop the padding
    bit, and read the message signed or unsigned."""
    t = np.asarray(phase, dtype=np.uint64) >> _U64(64 - bits - 2)
    t = ((t >> _U64(1)) + (t & _U64(1))) & _U64((1 << (bits + 1)) - 1)
    if signed:
        v = t.astype(np.int64)
        return np.where(v >= 1 << (bits - 1), v | np.int64(-1 << bits), v)
    return (t & _U64((1 << bits) - 1)).astype(np.int64)


def secret_key(seed: int, keyset: dict) -> np.ndarray:
    """The key that decrypts a single-partition circuit's outputs: the
    big key of `keyset` (its ``n_small``, ``glwe_dimension`` and
    ``polynomial_size``) drawn from `seed`."""
    return big_secret_key(seed, keyset["n_small"], keyset["glwe_dimension"],
                          keyset["polynomial_size"])


def read_output(secret: np.ndarray, out: np.ndarray,
                output: dict) -> np.ndarray:
    """One output array of ciphertexts, decrypted and decoded at the
    configuration's ``output`` encoding (``bits``, ``signed``)."""
    return decode(decrypt(secret, out), output["bits"], output["signed"])
