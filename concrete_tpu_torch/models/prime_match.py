"""Prime Match: bank-internal order crossing on encrypted order books.

Reference workload: frontends/concrete-python/examples/prime-match/
prime-match.py (J.P. Morgan's prime match protocol demo) — a bank and a
client each hold encrypted order lists (side, symbol, quantity); matched
quantities are computed without revealing unmatched interest.

Exercises the wide-op surface in one circuit: broadcast tensor
comparisons (``!=``/``==`` over a (B, 1) × (C,) grid), bitwise ``&``,
encrypted×encrypted ``np.minimum``, a tensor ``fhe.multivariate``, tagged
regions, axis reductions, and a MULTI-OUTPUT return (two result vectors).
At the default ``Configuration()`` it compiles to a multi-partition
circuit at sizes such as (10, 10, 10, 50) and (5, 5, 4, 7), and to a mono
one at (3, 2, 3, 3).

Counterpart of ``concrete_tpu/models/prime_match.py``: the same traced
function and inputset, so both packages compile it to the same circuit;
``compile`` also takes the port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


class PrimeMatch:
    """Match opposite-side orders on the same symbol; fill = min(quantities).

    Sides are 0 (buy) / 1 (sell); symbols are integers < n_symbols;
    quantities are bounded by max_quantity.
    """

    def __init__(self, n_bank: int, n_client: int,
                 n_symbols: int = 4, max_quantity: int = 7):
        self.n_bank = n_bank
        self.n_client = n_client
        self.n_symbols = n_symbols
        self.max_quantity = max_quantity

    def match_clear(self, bank_sides, bank_symbols, bank_quantities,
                    client_sides, client_symbols, client_quantities):
        sides_differ = bank_sides[:, None] != client_sides[None, :]
        symbols_match = bank_symbols[:, None] == client_symbols[None, :]
        can_fill = sides_differ & symbols_match
        matching = np.minimum(bank_quantities[:, None],
                              client_quantities[None, :])
        filled = can_fill * matching
        return filled.sum(axis=1), filled.sum(axis=0)

    def compile(self, configuration=None, device=None):
        def match(bank_sides, bank_symbols, bank_quantities,
                  client_sides, client_symbols, client_quantities):
            with fhe.tag("comparing-sides"):
                sides_differ = bank_sides.reshape(-1, 1) != client_sides
            with fhe.tag("comparing-symbols"):
                symbols_match = bank_symbols.reshape(-1, 1) == client_symbols
            with fhe.tag("fillable"):
                can_fill = sides_differ & symbols_match
            with fhe.tag("matching-quantity"):
                matching = np.minimum(bank_quantities.reshape(-1, 1),
                                      client_quantities)
            with fhe.tag("filled-quantity"):
                filled = fhe.multivariate(lambda f, q: f * q)(
                    can_fill, matching)
            return np.sum(filled, axis=1), np.sum(filled, axis=0)

        compiler = fhe.Compiler(
            match, {name: "encrypted" for name in
                    ("bank_sides", "bank_symbols", "bank_quantities",
                     "client_sides", "client_symbols", "client_quantities")})

        rng = np.random.default_rng(0)
        b, c = self.n_bank, self.n_client
        s, q = self.n_symbols, self.max_quantity
        inputset = [
            (rng.integers(0, 2, b), rng.integers(0, s, b),
             rng.integers(1, q + 1, b),
             rng.integers(0, 2, c), rng.integers(0, s, c),
             rng.integers(1, q + 1, c))
            for _ in range(20)
        ]
        # pin the bounds: everything matches at the max quantity
        inputset.append((np.zeros(b, np.int64), np.zeros(b, np.int64),
                         np.full(b, q), np.ones(c, np.int64),
                         np.zeros(c, np.int64), np.full(c, q)))
        return compiler.compile(inputset, configuration, device=device)
