"""Basic extensions: zeros/ones/constant, identity/refresh.

Reference: frontends/concrete-python/concrete/fhe/extensions/{zeros,ones,
constant,identity}.py.
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer
from concrete_tpu_torch.values import ValueDescription


def _encrypted_constant(value, shape=None):
    arr = np.asarray(value, dtype=np.int64)
    if shape is not None:
        arr = np.broadcast_to(arr, shape).copy()
    node_out = ValueDescription.of(arr, is_encrypted=True)

    def evaluator():
        return arr

    t = Tracer._generic("encrypted_constant", [], evaluator, node_out,
                        value=arr)
    return t


def zero():
    return _encrypted_constant(0)


def zeros(shape):
    return _encrypted_constant(0, shape=shape)


def one():
    return _encrypted_constant(1)


def ones(shape):
    return _encrypted_constant(1, shape=shape)


def constant(value):
    """An encrypted (trivially) constant."""
    return _encrypted_constant(value)


def zeros_like(array):
    """Encrypted zeros with the shape of `array` (reference
    extensions/zeros.py zeros_like)."""
    return zeros(getattr(array, "shape", np.asarray(array).shape))


def ones_like(array):
    """Encrypted ones with the shape of `array` (reference
    extensions/ones.py ones_like)."""
    return ones(getattr(array, "shape", np.asarray(array).shape))


def identity(x):
    """Identity TLU: refreshes noise via one bootstrap.

    Reference: extensions/identity.py (FHE.identity / refresh semantics).
    """
    from concrete_tpu_torch.extensions.univariate import univariate
    return univariate(lambda v: v)(x)


refresh = identity
