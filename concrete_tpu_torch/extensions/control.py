"""Control-flow-ish extensions: if_then_else / mux, relu.

Reference: frontends/concrete-python/concrete/fhe/extensions/ (mux/relu) and
the FHE dialect's mux lowering.
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer


def relu(x):
    """max(x, 0) as one TLU (reference mlir/context.py:3149)."""
    if not isinstance(x, Tracer):
        return np.maximum(np.asarray(x), 0)
    from concrete_tpu_torch.extensions.univariate import univariate
    return univariate(lambda v: max(int(v), 0))(x)


def if_then_else(condition, when_true, when_false):
    """Encrypted select: condition must be a 0/1 value.

    Lowered arithmetically: b + c * (a - b); the encrypted multiplication
    becomes two TLUs (EncryptedMulToDoubleTLU).
    """
    c = condition
    a = when_true
    b = when_false
    return b + c * (a - b)


mux = if_then_else
