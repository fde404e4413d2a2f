"""fhe.univariate — arbitrary pointwise functions as table lookups.

Reference: frontends/concrete-python/concrete/fhe/extensions/univariate.py.
The table is materialized at compile time from the operand's measured bounds
(lut[i] = f(i) over the operand's input domain).
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer


def univariate(function):
    """Wrap a scalar function for use on encrypted values: the compiler turns
    it into a single programmable bootstrap."""

    def wrapper(x):
        if not isinstance(x, Tracer):
            return function(x)

        def evaluator(v):
            return np.vectorize(function, otypes=[np.int64])(np.asarray(v))

        output = Tracer._infer_output("univariate", evaluator, [x])
        return Tracer._generic("univariate", [x], evaluator, output,
                               function=function)

    return wrapper
