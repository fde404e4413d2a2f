"""Direct-circuit type annotations: declare ranges instead of inputsets.

Reference: frontends/concrete-python/concrete/fhe/tracing/typing.py (1223
LoC of int1..int64 / uint1.. / tensor[...] annotations used by
``@fhe.circuit`` "direct" definitions).  Annotated parameters give exact
dtype/shape, so no inputset measurement is needed — bounds come from the
annotation's range (the reference solves the same constraints with z3;
with mono parameters the propagated interval bounds are equivalent).

    @fhe.circuit({"x": "encrypted"})
    def f(x: fhe.uint3):
        return x + 1
"""

from __future__ import annotations

import numpy as np


class _IntAnnotationMeta(type):
    def __getitem__(cls, shape):
        if not isinstance(shape, tuple):
            shape = (shape,)
        # fhe.tensor[fhe.uint3, 4, 5]: the scalar class leads the tuple
        if shape and isinstance(shape[0], _IntAnnotationMeta):
            cls, shape = shape[0], shape[1:]
        return _TensorAnnotation(cls, shape)

    @property
    def dtype_range(cls):
        if cls.is_signed:
            half = 1 << (cls.bit_width - 1)
            return (-half, half - 1)
        return (0, (1 << cls.bit_width) - 1)


class _IntAnnotation(metaclass=_IntAnnotationMeta):
    bit_width = 0
    is_signed = False
    shape = ()


class _TensorAnnotation:
    def __init__(self, scalar, shape):
        self.scalar = scalar
        self.shape = tuple(shape)

    @property
    def dtype_range(self):
        return self.scalar.dtype_range

    @property
    def bit_width(self):
        return self.scalar.bit_width

    @property
    def is_signed(self):
        return self.scalar.is_signed


def _make(width: int, signed: bool):
    name = f"{'int' if signed else 'uint'}{width}"
    return _IntAnnotationMeta(name, (_IntAnnotation,),
                              {"bit_width": width, "is_signed": signed})


_globals = globals()
for _w in range(1, 65):
    _globals[f"uint{_w}"] = _make(_w, False)
    _globals[f"int{_w}"] = _make(_w, True)

tensor = _IntAnnotation  # fhe.tensor[fhe.uint3, 4] via the metaclass


class _FloatAnnotationMeta(type):
    def __getitem__(cls, shape):
        if not isinstance(shape, tuple):
            shape = (shape,)
        return _TensorAnnotation(cls, shape)


class f32(metaclass=_FloatAnnotationMeta):
    """Float annotation for fused subgraph intermediates (reference
    tracing/typing.py f32). Floats must be fused away before lowering."""
    bit_width = 32
    is_signed = True
    is_float = True
    shape = ()


class f64(f32):
    bit_width = 64


def annotation_sample(ann):
    """A max-range sample value for tracing/bounds from an annotation."""
    lo, hi = ann.dtype_range
    shape = getattr(ann, "shape", ())
    if shape == ():
        return np.int64(hi)
    arr = np.full(shape, hi, dtype=np.int64)
    if arr.size >= 2:
        arr.reshape(-1)[0] = lo
    return arr


def annotation_inputset(ann_list):
    """Synthetic inputset hitting every corner combination of the annotated
    parameter ranges (so interval bounds of intermediates are exact for
    monotone-per-argument ops; the reference derives the same with z3)."""
    import itertools
    corners_per_param = []
    for ann in ann_list:
        lo, hi = ann.dtype_range
        shape = getattr(ann, "shape", ())
        if shape == ():
            corners_per_param.append((np.int64(lo), np.int64(hi)))
        else:
            corners_per_param.append(
                (np.full(shape, lo, dtype=np.int64),
                 np.full(shape, hi, dtype=np.int64)))
    if len(corners_per_param) > 4:   # cap the cartesian blowup
        corners_per_param = [c[:2] for c in corners_per_param[:4]] + [
            (c[0],) for c in corners_per_param[4:]]
    return [tuple(s) for s in itertools.product(*corners_per_param)]
