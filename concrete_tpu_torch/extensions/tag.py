"""fhe.tag — region tags for statistics/debugging.

Reference: frontends/concrete-python/concrete/fhe/extensions/tag.py: a
context manager stacking tag names onto traced nodes; surfaced in statistics
(per-tag PBS counts, reference circuit.py statistics properties).
"""

from __future__ import annotations

import contextlib

_TAG_STACK: list[str] = []


@contextlib.contextmanager
def tag(name: str):
    _TAG_STACK.append(name)
    try:
        yield
    finally:
        _TAG_STACK.pop()


def current_tag() -> str:
    return ".".join(_TAG_STACK)


def hint(x, bit_width: int = None, can_store=None):
    """Bit-width hint (reference extensions/hint.py): widen the traced
    value's measured bounds so the compiler allocates at least `bit_width`
    bits.  `can_store` accepts a type annotation (fhe.uint8, a tensor
    annotation, or an Integer dtype) as the reference API does."""
    from concrete_tpu_torch.tracing.tracer import Tracer
    if can_store is not None and bit_width is None:
        bit_width = getattr(can_store, "bit_width", None)
        if not bit_width:
            raise TypeError(
                f"can_store must carry a bit_width (e.g. fhe.uint8); "
                f"got {can_store!r}")
    if not isinstance(x, Tracer) or bit_width is None:
        return x
    lo = 0
    hi = (1 << bit_width) - 1
    ev = lambda v: v  # noqa: E731
    out = Tracer._generic("hint", [x], ev, x.node.output,
                          bit_width=bit_width)
    # seed bounds so measure_bounds folds them in
    out.node.bounds = (lo, hi)
    return out