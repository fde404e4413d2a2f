"""SHA1 over encrypted data, computed as a module of bit-vector primitives.

Reference workload: frontends/concrete-python/examples/sha1/sha1.py — the
hash state lives as 32-bit words split into LSB-first bit vectors; the
server evaluates the 80-round compression loop by composing a small FHE
module (round functions, rotations, modular adders) while the host drives
the clear control flow.

Lowerings differ from the reference where TPU batching helps:

- the round functions ``Ch``/``Parity``/``Maj`` are one packed multivariate
  TLU per bit (the whole 32-bit word bootstraps as one batched PBS);
- ``round_add`` sums all five operands per column first, then runs a single
  carry chain (carry <= 4, 4-bit TLUs) instead of four chained 2-ary adds;
- rotations are pure re-indexing (no PBS).

Counterpart of ``concrete_tpu/models/sha1.py``: the same module, so both
packages compile it to the same graphs and parameters; ``compile`` also
takes the port's ``device``.  ``digest`` runs in ``mode="simulate"`` (the
default: the host simulation, no keys) or ``mode="run"`` (encrypt, run
every function on the device, decrypt).
"""

from __future__ import annotations

import struct

import numpy as np

import concrete_tpu_torch as fhe

_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)
_H0 = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)


def split32(value: int) -> np.ndarray:
    """32-bit word -> LSB-first bit vector."""
    return np.array([(int(value) >> i) & 1 for i in range(32)],
                    dtype=np.int64)


def unsplit32(bits) -> int:
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def _rotl(x, amount: int):
    """Left-rotate of the *value* = roll of the LSB-first bit vector."""
    return np.concatenate([x[32 - amount:], x[:32 - amount]])


def _carry_add(columns, max_carry: int):
    """Ripple add of per-column sums: two TLUs per column (bit, carry).

    ``max_carry`` documents the worst-case incoming carry (1 for 2-ary
    adds, 4 for the 5-ary round add); the bounds are pinned by the
    all-ones inputset rows.
    """
    del max_carry
    out = fhe.zeros(32)
    carry = None
    for i in range(32):
        s = columns[i] if carry is None else columns[i] + carry
        out[i] = fhe.univariate(lambda v: int(v) % 2)(s)
        if i != 31:
            carry = fhe.univariate(lambda v: int(v) // 2)(s)
    return out


def _make_module():
    @fhe.module()
    class Sha1Module:
        @fhe.function({"x": "encrypted", "y": "encrypted", "z": "encrypted"})
        def choose(x, y, z):
            # rounds 0-19: z ^ (x & (y ^ z)), one packed TLU per bit
            return fhe.multivariate(lambda x, y, z: z ^ (x & (y ^ z)))(
                x, y, z)

        @fhe.function({"x": "encrypted", "y": "encrypted", "z": "encrypted"})
        def parity(x, y, z):
            # rounds 20-39 and 60-79: x ^ y ^ z
            return fhe.multivariate(lambda x, y, z: x ^ y ^ z)(x, y, z)

        @fhe.function({"x": "encrypted", "y": "encrypted", "z": "encrypted"})
        def majority(x, y, z):
            # rounds 40-59: (x & y) | (z & (x | y))
            return fhe.multivariate(
                lambda x, y, z: (x & y) | (z & (x | y)))(x, y, z)

        @fhe.function({"x": "encrypted"})
        def rotate30(x):
            return _rotl(x, 30)

        @fhe.function({"x": "encrypted", "y": "encrypted"})
        def add2(x, y):
            return _carry_add(x + y, max_carry=1)

        @fhe.function({"a": "encrypted", "f": "encrypted", "e": "encrypted",
                       "w": "encrypted", "k": "encrypted"})
        def round_add(a, f, e, w, k):
            # rot5(a) + f + e + w + k mod 2^32: one carry chain, carry <= 4
            arot5 = _rotl(a, 5)
            return _carry_add(arot5 + f + e + w + k, max_carry=4)

    return Sha1Module


class Sha1:
    """The host side: composes the module over padded message chunks."""

    def __init__(self):
        self._module_cls = _make_module()
        self.module = None

    def compile(self, configuration=None, inputset_size: int = 12,
                device=None):
        rng = np.random.default_rng(0)

        def bitvecs(n_args):
            sets = [tuple(rng.integers(0, 2, 32) for _ in range(n_args))
                    for _ in range(inputset_size)]
            # pin bounds: every column at its maximum
            sets.append(tuple(np.ones(32, np.int64)
                              for _ in range(n_args)))
            return sets

        self.module = self._module_cls.compile(
            {"choose": bitvecs(3), "parity": bitvecs(3),
             "majority": bitvecs(3), "rotate30": bitvecs(1),
             "add2": bitvecs(2), "round_add": bitvecs(5)},
            configuration, device=device)
        return self.module

    # -- driving ----------------------------------------------------------

    @staticmethod
    def _pad(message: bytes) -> bytes:
        length = len(message) * 8
        message += b"\x80"
        message += b"\x00" * ((56 - len(message) % 64) % 64)
        return message + struct.pack(b">Q", length)

    @staticmethod
    def _schedule(chunk: bytes) -> list[np.ndarray]:
        w = [struct.unpack(b">I", chunk[i * 4:i * 4 + 4])[0]
             for i in range(16)]
        for i in range(16, 80):
            v = w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16]
            w.append(((v << 1) | (v >> 31)) & 0xFFFFFFFF)
        return [split32(v) for v in w]

    def digest(self, message: bytes, mode: str = "simulate") -> bytes:
        """SHA1 digest; ``mode="simulate"`` (noise-accurate, no keys, on
        the host) or ``"run"`` (full encrypt/run/decrypt through the
        keyset)."""
        if self.module is None:
            raise RuntimeError("call compile() first")
        m = self.module
        if mode == "simulate":
            call = lambda fn, *args: np.asarray(fn.simulate(*args))  # noqa: E731
            lift = np.asarray
            lower = np.asarray
        elif mode == "run":
            call = lambda fn, *args: fn.run(*args)  # noqa: E731
            lift = m.rotate30.encrypt        # encrypts (does not rotate)
            lower = m.add2.decrypt
        else:
            raise ValueError(f"unknown mode {mode!r}")

        h = [lift(split32(v)) for v in _H0]
        padded = self._pad(message)
        for start in range(0, len(padded), 64):
            chunk = padded[start:start + 64]
            w = [lift(bits) for bits in self._schedule(chunk)]
            k = [lift(split32(v)) for v in _K]
            a, b, c, d, e = h
            for i in range(80):
                f_fn = (m.choose if i < 20 else
                        m.majority if 40 <= i < 60 else m.parity)
                f = call(f_fn, b, c, d)
                s = call(m.round_add, a, f, e, w[i], k[i // 20])
                a, b, c, d, e = s, a, call(m.rotate30, b), c, d
            h = [call(m.add2, h_i, v)
                 for h_i, v in zip(h, (a, b, c, d, e))]

        words = [unsplit32(np.asarray(lower(v))) for v in h]
        return struct.pack(b">5I", *words)

    def hexdigest(self, message: bytes, mode: str = "simulate") -> str:
        return self.digest(message, mode).hex()
