"""fhe.LookupTable — explicit table lookups.

Reference: frontends/concrete-python/concrete/fhe/extensions/table.py:15.
`table[x]` on an encrypted value becomes a TLU node executed as one
programmable bootstrap; negative indices wrap (lut[-1] == lut[len - 1]),
matching the reference's indexing semantics for signed inputs.

Multi-dimensional tables (shape (..., 2^p)) apply a DIFFERENT table to
each element of a matching-shape encrypted tensor — the analog of
FHELinalg's apply_multi_lookup_table (and, by precomputing table[map] in
the clear, apply_mapped_lookup_table).  The whole tensor still runs as
ONE batched PBS (the kernel takes per-row LUT polynomials natively).
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer
from concrete_tpu_torch.values import ValueDescription


class LookupTable:
    def __init__(self, table):
        if isinstance(table, (list, tuple)) and table \
                and isinstance(table[0], LookupTable):
            table = [t.table for t in table]
        self.table = np.asarray(table, dtype=np.int64)
        n = self.table.shape[-1]
        if n & (n - 1):
            raise ValueError(
                "LookupTable's last dimension must be a power of two")

    def __len__(self) -> int:
        return self.table.shape[-1]

    def _apply_clear(self, index):
        m = self.table.shape[-1]
        if self.table.ndim == 1:
            if isinstance(index, (int, np.integer)):
                return self.table[int(index) % m]
            return self.table[np.asarray(index) % m]
        idx = (np.asarray(index) % m)[..., None]
        return np.take_along_axis(self.table, idx, axis=-1)[..., 0]

    def __getitem__(self, index):
        if not isinstance(index, Tracer):
            return self._apply_clear(index)
        table = self.table
        if table.ndim > 1 \
                and tuple(index.node.output.shape) != table.shape[:-1]:
            raise ValueError(
                f"multi-table LookupTable of shape {table.shape[:-1]} "
                f"cannot index a value of shape "
                f"{tuple(index.node.output.shape)}")

        def evaluator(x):
            return self._apply_clear(x)

        output = ValueDescription.of(
            np.zeros(index.node.output.shape, dtype=np.int64),
            is_encrypted=index.node.output.is_encrypted)
        out_desc = ValueDescription(
            dtype=ValueDescription.of(table).dtype,
            shape=output.shape, is_encrypted=output.is_encrypted)
        return Tracer._generic("tlu", [index], evaluator, out_desc,
                               table=table)

    def __repr__(self) -> str:
        return f"LookupTable{self.table.tolist()}"
