"""Data types for traced values.

Mirrors the reference's ``concrete/fhe/dtypes/`` (Integer/Float) —
frontends/concrete-python/concrete/fhe/dtypes/integer.py — with only what the
TPU build needs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Integer:
    bit_width: int
    is_signed: bool

    @classmethod
    def that_can_represent(cls, values) -> "Integer":
        arr = np.asarray(values)
        if arr.size == 0:
            return cls(1, False)
        lo = int(arr.min())
        hi = int(arr.max())
        is_signed = lo < 0
        if is_signed:
            w = 1
            while not (-(1 << (w - 1)) <= lo and hi < (1 << (w - 1))):
                w += 1
            bit_width = w
        else:
            bit_width = max(hi.bit_length(), 1)
        return cls(bit_width, is_signed)

    @property
    def min(self) -> int:
        return -(1 << (self.bit_width - 1)) if self.is_signed else 0

    @property
    def max(self) -> int:
        return ((1 << (self.bit_width - 1)) - 1) if self.is_signed \
            else ((1 << self.bit_width) - 1)

    def can_represent(self, value: int) -> bool:
        return self.min <= value <= self.max

    def __str__(self) -> str:
        return f"{'int' if self.is_signed else 'uint'}{self.bit_width}"


@dataclasses.dataclass(frozen=True)
class Float:
    bit_width: int = 64

    def __str__(self) -> str:
        return f"float{self.bit_width}"
