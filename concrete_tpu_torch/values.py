"""Value descriptions: dtype + shape + encryption status.

Reference: frontends/concrete-python/concrete/fhe/values/value_description.py:173.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from concrete_tpu_torch.dtypes import Float, Integer


@dataclasses.dataclass(frozen=True)
class ValueDescription:
    dtype: object           # Integer or Float
    shape: tuple
    is_encrypted: bool

    @classmethod
    def of(cls, value, is_encrypted: bool = False) -> "ValueDescription":
        arr = np.asarray(value)
        if np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_:
            dtype = Integer.that_can_represent(arr.astype(np.int64))
        else:
            dtype = Float(64)
        return cls(dtype=dtype, shape=tuple(arr.shape),
                   is_encrypted=is_encrypted)

    @property
    def is_scalar(self) -> bool:
        return self.shape == ()

    @property
    def is_clear(self) -> bool:
        return not self.is_encrypted

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def __str__(self) -> str:
        kind = "Encrypted" if self.is_encrypted else "Clear"
        if self.shape == ():
            return f"{kind}Scalar<{self.dtype}>"
        return f"{kind}Tensor<{self.dtype}, shape={self.shape}>"
