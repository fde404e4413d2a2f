"""Private information retrieval: fetch a database row by encrypted index.

Reference workload: frontends/concrete-python/examples/pir (query a clear
server-side table with an encrypted index; the server learns nothing about
which row was fetched).

The row fetch lowers to ONE batched PBS: the encrypted index is broadcast
to ``row_width`` copies and a multi-dimensional LookupTable applies column
j's table ``db[:, j]`` to copy j (the apply_multi_lookup_table path), so
all columns bootstrap together.

Counterpart of ``concrete_tpu/models/pir.py``: the same traced function, so
both packages compile it to the same circuit; ``compile`` also takes the
port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


class PrivateInformationRetrieval:
    def __init__(self, database):
        db = np.asarray(database, dtype=np.int64)
        if db.ndim == 1:
            db = db[:, None]
        if db.ndim != 2:
            raise ValueError("database must be 1-D or 2-D")
        n = db.shape[0]
        if n & (n - 1):
            raise ValueError("number of rows must be a power of two "
                             "(pad with zero rows)")
        self.db = db

    def query_clear(self, index: int) -> np.ndarray:
        return self.db[int(index)]

    def compile(self, configuration=None, device=None):
        n_rows, row_width = self.db.shape
        # column tables: copy j of the index looks up db[:, j]
        tables = fhe.LookupTable(self.db.T.copy())

        @fhe.compiler({"index": "encrypted"})
        def query(index):
            idx_vec = fhe.ones(row_width) * index
            return tables[idx_vec]

        inputset = list(range(n_rows))
        return query.compile(inputset, configuration, device=device)
