"""Encrypted Hamming (XOR) distance between bit-packed vectors.

Reference workload: frontends/concrete-python/examples/xor_distance/
hamming_distance.py — two parties hold w-bit-packed binary vectors; the
distance is sum(popcount(x ^ y)).  Two lowerings are offered, matching the
reference's variants:

- ``via="xor"``: ``x ^ y`` lowers to one packed multivariate TLU per word
  (the bitwise-op strategy), then a popcount LookupTable TLU.
- ``via="packed"``: popcount(x ^ y) folds into a SINGLE TLU over the
  packed index ``x + 2^w * y`` (one PBS per word instead of two) — the
  reference's ``dist_in_fhe_with_multivariate_internal`` trick.

Either way the whole vector runs as one batched PBS.  At the default
``Configuration()`` the "xor" lowering compiles to a multi-partition
circuit: the xor lookups in one partition, the popcount in another, a
conversion keyswitch between them.

Counterpart of ``concrete_tpu/models/xor_distance.py``: the same traced function, so
both packages compile it to the same circuit; ``compile`` also takes the
port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


def _popcount_table(bits: int) -> list[int]:
    return [bin(v).count("1") for v in range(1 << bits)]


class HammingDistance:
    """dist(x, y) = sum_i popcount(x_i ^ y_i) over w-bit words."""

    def __init__(self, n_words: int, word_bits: int = 4):
        if word_bits < 1:
            raise ValueError("word_bits must be >= 1")
        self.n_words = n_words
        self.word_bits = word_bits

    def distance_clear(self, x, y) -> int:
        x = np.asarray(x, dtype=np.int64)
        y = np.asarray(y, dtype=np.int64)
        table = np.array(_popcount_table(self.word_bits))
        return int(table[x ^ y].sum())

    def compile(self, configuration=None, via: str = "packed",
                device=None):
        w = self.word_bits
        n = self.n_words
        pop = _popcount_table(w)

        if via == "packed":
            # popcount((z % 2^w) ^ (z // 2^w)) over the packed index
            packed = fhe.LookupTable(
                [pop[(i & ((1 << w) - 1)) ^ (i >> w)]
                 for i in range(1 << (2 * w))])

            @fhe.compiler({"x": "encrypted", "y": "encrypted"})
            def dist(x, y):
                z = x + (1 << w) * y
                return np.sum(packed[z])
        elif via == "xor":
            pop_table = fhe.LookupTable(pop)

            @fhe.compiler({"x": "encrypted", "y": "encrypted"})
            def dist(x, y):
                return np.sum(pop_table[x ^ y])
        else:
            raise ValueError(f"unknown lowering {via!r}")

        rng = np.random.default_rng(0)
        hi = 1 << w
        inputset = [(rng.integers(0, hi, n), rng.integers(0, hi, n))
                    for _ in range(30)]
        # pin the packed-index bound (both words at max)
        inputset.append((np.full(n, hi - 1), np.full(n, hi - 1)))
        inputset.append((np.zeros(n, dtype=np.int64),
                         np.zeros(n, dtype=np.int64)))
        return dist.compile(inputset, configuration, device=device)
