"""Encrypted Levenshtein distance between two short strings.

Reference workload: frontends/concrete-python/benchmarks/
levenshtein_distance.py — dynamic programming over encrypted characters,
equality via TLU and the three-way min via max/min chains.

Counterpart of ``concrete_tpu/models/levenshtein.py``: the same traced function, so
both packages compile it to the same circuit; ``compile`` also takes the
port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


class LevenshteinDistance:
    def __init__(self, length_a: int = 3, length_b: int = 3,
                 alphabet_bits: int = 2):
        self.la = length_a
        self.lb = length_b
        self.alphabet_bits = alphabet_bits

    @staticmethod
    def distance_clear(a, b) -> int:
        la, lb = len(a), len(b)
        dp = [[0] * (lb + 1) for _ in range(la + 1)]
        for i in range(la + 1):
            dp[i][0] = i
        for j in range(lb + 1):
            dp[0][j] = j
        for i in range(1, la + 1):
            for j in range(1, lb + 1):
                cost = 0 if a[i - 1] == b[j - 1] else 1
                dp[i][j] = min(dp[i - 1][j] + 1, dp[i][j - 1] + 1,
                               dp[i - 1][j - 1] + cost)
        return dp[la][lb]

    def compile(self, configuration=None, inputset_size: int = 12,
                seed: int = 0, device=None):
        la, lb = self.la, self.lb

        @fhe.compiler({"a": "encrypted", "b": "encrypted"})
        def distance(a, b):
            dp = [[None] * (lb + 1) for _ in range(la + 1)]
            for i in range(la + 1):
                dp[i][0] = fhe.constant(i)
            for j in range(1, lb + 1):
                dp[0][j] = fhe.constant(j)
            for i in range(1, la + 1):
                for j in range(1, lb + 1):
                    neq = fhe.multivariate(
                        lambda u, v: int(u != v))(a[i - 1], b[j - 1])
                    d1 = dp[i - 1][j] + 1
                    d2 = dp[i][j - 1] + 1
                    d3 = dp[i - 1][j - 1] + neq
                    dp[i][j] = np.minimum(np.minimum(d1, d2), d3)
            return dp[la][lb]

        rng = np.random.default_rng(seed)
        hi = 1 << self.alphabet_bits
        inputset = [(rng.integers(0, hi, (la,)), rng.integers(0, hi, (lb,)))
                    for _ in range(inputset_size)]
        return distance.compile(inputset, configuration, device=device)
