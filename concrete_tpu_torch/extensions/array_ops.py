"""fhe.array / fhe.inputset — construction helpers.

Reference: frontends/concrete-python/concrete/fhe/extensions/array.py
(fhe.array packs mixed encrypted scalars/clears into one encrypted tensor)
and compilation/utils.py inputset() (random inputset generation from type
annotations).
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer
from concrete_tpu_torch.values import ValueDescription


def array(values) -> Tracer:
    """Build an encrypted tensor from scalars/tracers (fhe.array).

    Clear entries are trivially encrypted; all entries must be scalars.
    """
    def walk(v):
        """Recursive flatten treating Tracers as leaves (np.asarray would
        descend INTO tensor tracers via __getitem__, exploding them into
        per-element index nodes)."""
        if isinstance(v, Tracer):
            if v.node.output.shape != ():
                raise ValueError("fhe.array entries must be scalars")
            return [v], ()
        if isinstance(v, (list, tuple)):
            parts = [walk(x) for x in v]
            if not parts:
                return [], (0,)
            shapes = {s for _, s in parts}
            if len(shapes) != 1:
                raise ValueError("fhe.array entries have ragged shapes")
            flat = [x for p, _ in parts for x in p]
            return flat, (len(parts),) + parts[0][1]
        return [v], ()

    flat, shape = walk(values)
    if not any(isinstance(v, Tracer) for v in flat):
        return np.asarray(values, dtype=np.int64)

    class arr:                         # shape carrier for the code below
        pass
    arr.shape = shape

    def sanitize(v):
        if isinstance(v, Tracer):
            if v.node.output.shape != ():
                raise ValueError("fhe.array entries must be scalars")
            return v
        from concrete_tpu_torch.extensions.basics import _encrypted_constant
        return _encrypted_constant(int(v))

    tracers = [sanitize(v) for v in flat]
    out_desc = ValueDescription(dtype=None, shape=tuple(arr.shape),
                                is_encrypted=True)

    def evaluator(*vals):
        return np.asarray(vals, dtype=np.int64).reshape(arr.shape)

    return Tracer._generic("array", tracers, evaluator, out_desc,
                       shape=tuple(arr.shape))


def inputset(*annotations, n: int = 100, seed=None):
    """Random inputset from fhe.intN/uintN[/tensor] annotations (reference
    fhe.inputset): e.g. inputset(fhe.uint3, fhe.tensor[fhe.uint2, 4])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sample = []
        for ann in annotations:
            if not hasattr(ann, "dtype_range"):
                raise TypeError(f"not a type annotation: {ann!r}")
            lo, hi = ann.dtype_range
            shape = getattr(ann, "shape", ())
            val = rng.integers(lo, hi + 1, size=shape)
            sample.append(val if shape else int(val))
        out.append(tuple(sample) if len(sample) != 1 else sample[0])
    return out
