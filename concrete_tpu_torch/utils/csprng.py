"""Cryptographically secure randomness for key generation and encryption.

The reference splits randomness into a *secret* CSPRNG (key material) and an
*encryption* CSPRNG (masks/noise) — include/concretelang/Common/Csprng.h:18-61
over concrete-cpu's ChaCha-based c_api/csprng.rs.  Here the native ChaCha20
stream lives in the package's own copy of csrc/chacha20.c (built with `cc`
into the git-ignored ``_build/`` on first use, bound via ctypes) and is
exposed through a numpy-Generator-compatible adapter so the keygen code can
use either.  Same source and seed as the JAX package: same keystream.

SecureGenerator seeds from os.urandom by default; pass an explicit 32-byte
seed for reproducible (e.g. test) keys.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_LIB = None


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: git-ignored directory of the package's native builds (this library and
#: the CUDA kernels of ops/_build.py)
BUILD_DIR = os.path.join(_PKG, "_build")


def _build_and_load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    src = os.path.join(_PKG, "csrc", "chacha20.c")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libchacha20_{tag}.so")
    if not os.path.exists(so_path):
        # build under a private name, then rename: concurrent test workers
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        subprocess.run(["cc", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                       check=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.chacha20_fill.restype = ctypes.c_uint32
    lib.chacha20_fill.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_uint64]
    _LIB = lib
    return lib


class ChaCha20Stream:
    """Raw keystream: 256-bit seed + 96-bit nonce, monotone block counter."""

    def __init__(self, seed: Optional[bytes] = None, nonce: bytes = b"\0" * 12):
        if seed is None:
            seed = os.urandom(32)
        if len(seed) != 32:
            seed = hashlib.sha256(seed).digest()
        self.seed = seed
        self.nonce = nonce
        self.counter = 0
        self._lib = _build_and_load()

    def _bump_nonce(self) -> None:
        v = int.from_bytes(self.nonce, "little") + 1
        self.nonce = (v % (1 << 96)).to_bytes(12, "little")

    def reserve(self, n: int) -> tuple:
        """Advance the stream past the `n` bytes that ``random_bytes(n)``
        would return, without making them; returns where they start,
        (nonce, block counter), for ``bytes_at``.  A draw that is made
        later, or in parts on other threads, is then bit for bit the one
        the stream would have made here."""
        # the 32-bit block counter covers 256 GiB per nonce; advance the
        # nonce before it wraps so keystream (thus LWE masks) never repeats
        blocks = (n + 63) // 64
        if blocks > 0xFFFFFFFF - self.counter:
            self._bump_nonce()
            self.counter = 0
        start = (self.nonce, self.counter)
        self.counter = (self.counter + blocks) & 0xFFFFFFFF
        if self.counter == 0 and blocks:
            self._bump_nonce()
        return start

    def bytes_at(self, start: tuple, offset: int, n: int) -> bytes:
        """`n` bytes at byte `offset` of a reserved region (``reserve``'s
        `start`): a seek, since the keystream is counter-based."""
        nonce, counter = start
        skip = offset % 64
        out = ctypes.create_string_buffer(skip + n)
        self._lib.chacha20_fill(self.seed, counter + offset // 64, nonce,
                                out, skip + n)
        return out.raw[skip:]

    def words_at(self, start: tuple, offset: int, count: int) -> np.ndarray:
        """``bytes_at`` as `count` u64 words at word `offset`, written by
        the keystream straight into a new (writable) array."""
        nonce, counter = start
        skip = offset % 8
        out = np.empty(skip + count, dtype=np.uint64)
        self._lib.chacha20_fill(self.seed, counter + offset // 8, nonce,
                                out.ctypes.data, 8 * (skip + count))
        return out[skip:]

    def random_bytes(self, n: int) -> bytes:
        return self.bytes_at(self.reserve(n), 0, n)

    def random_u64(self, shape) -> np.ndarray:
        n = int(np.prod(shape)) if shape else 1
        buf = self.random_bytes(8 * n)
        return np.frombuffer(buf, dtype=np.uint64).reshape(shape)


class SecureGenerator:
    """numpy-Generator-compatible adapter over the ChaCha20 stream.

    Supports the subset the crypto core uses: `integers` (any range;
    power-of-two ranges are a single masked draw, others use unbiased
    mask-and-reject sampling) and `normal`.
    """

    def __init__(self, seed: Optional[bytes | int] = None):
        if isinstance(seed, int):
            seed = seed.to_bytes(32, "little", signed=False) \
                if seed >= 0 else hashlib.sha256(str(seed).encode()).digest()
        self.stream = ChaCha20Stream(seed)

    def integers(self, low, high, size=None, dtype=np.int64):
        span = int(high) - int(low)
        if span <= 0:
            raise ValueError("high must be greater than low")
        shape = size if size is not None else ()
        if isinstance(shape, int):
            shape = (shape,)
        n = int(np.prod(shape)) if shape else 1
        if span & (span - 1) == 0:  # power of two: one masked draw
            u = self.stream.random_u64((n,))
            out = u if span == 1 << 64 else u & np.uint64(span - 1)
        else:  # mask to the next power of two, reject out-of-range draws
            mask = np.uint64((1 << (span - 1).bit_length()) - 1)
            out = np.empty(n, dtype=np.uint64)
            filled = 0
            while filled < n:
                draw = self.stream.random_u64((n - filled,)) & mask
                good = draw[draw < span]
                out[filled:filled + good.size] = good
                filled += good.size
        if int(low) != 0:
            out = (out.astype(np.int64) + np.int64(low)).astype(dtype)
        else:
            out = out.astype(dtype)
        return out.reshape(shape) if shape else out[0]

    def normal(self, loc=0.0, scale=1.0, size=None):
        shape = size if size is not None else ()
        if isinstance(shape, int):
            shape = (shape,)
        n = int(np.prod(shape)) if shape else 1
        # Box-Muller over 53-bit uniforms
        m = (n + 1) // 2
        u = self.stream.random_u64((2, m)).astype(np.float64) / 2.0 ** 64
        u1 = np.clip(u[0], 1e-300, 1.0)
        u2 = u[1]
        r = np.sqrt(-2.0 * np.log(u1))
        z = np.concatenate([r * np.cos(2 * np.pi * u2),
                            r * np.sin(2 * np.pi * u2)])[:n]
        out = loc + scale * z
        return out.reshape(shape) if shape else out[0]


# RFC 8439 section 2.3.2 test vector (block 1 keystream head)
RFC8439_KEY = bytes(range(32))
RFC8439_NONCE = bytes.fromhex("000000090000004a00000000")
RFC8439_BLOCK1_HEAD = bytes.fromhex("10f1e7e4d13b5915500fdd1fa32071c4")
