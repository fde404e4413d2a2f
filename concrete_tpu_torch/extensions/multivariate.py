"""fhe.multivariate — functions of several encrypted values as one TLU.

Reference: frontends/concrete-python/concrete/fhe/extensions/multivariate.py
and the packing lowering in mlir/context.py:1325: operands are packed into a
single value (x << bits(y) | y) and a single table lookup is applied.  The
packing factor is resolved at compile time from measured bit widths (the
executor does it); the traced node just records the function.
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer


def multivariate(function):
    """Wrap an n-ary function for encrypted evaluation via one packed TLU.

    All operands must be encrypted; cost grows with the sum of operand bit
    widths (the packed precision).
    """

    def wrapper(*args):
        if not any(isinstance(a, Tracer) for a in args):
            return function(*args)
        operands = [Tracer.sanitize(a) for a in args]
        for i, op in enumerate(operands):
            if not op.node.output.is_encrypted:
                raise ValueError(
                    f"fhe.multivariate operand {i} is not encrypted — all "
                    "operands must be encrypted (the packed TLU adds them "
                    "into one ciphertext index)")

        def evaluator(*vals):
            return np.vectorize(function, otypes=[np.int64])(*vals)

        output = Tracer._infer_output("multivariate", evaluator, operands)
        return Tracer._generic("multivariate", operands, evaluator, output,
                               function=function)

    return wrapper
