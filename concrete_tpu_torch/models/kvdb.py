"""Encrypted static key-value database.

Reference workload: frontends/concrete-python/benchmarks/static_kvdb.py and
examples/key_value_database: query a fixed table with an encrypted key; the
match flags are TLU equality checks and the value is a masked sum.

Counterpart of ``concrete_tpu/models/kvdb.py``: the same traced function, so
both packages compile it to the same circuit; ``compile`` also takes the
port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


class StaticKeyValueDatabase:
    def __init__(self, keys, values):
        self.db_keys = np.asarray(keys, dtype=np.int64)
        self.db_values = np.asarray(values, dtype=np.int64)
        assert len(self.db_keys) == len(self.db_values)

    def query_clear(self, key: int) -> int:
        hits = self.db_keys == key
        return int((self.db_values * hits).sum())

    def compile(self, configuration=None, device=None):
        db_keys = self.db_keys
        db_values = self.db_values

        @fhe.compiler({"key": "encrypted"})
        def query(key):
            out = None
            for k, v in zip(db_keys, db_values):
                flag = fhe.univariate(
                    lambda q, k=int(k): int(q == k))(key)
                term = flag * int(v)
                out = term if out is None else out + term
            return out

        inputset = list(range(int(self.db_keys.max()) + 2))
        return query.compile(inputset, configuration, device=device)
