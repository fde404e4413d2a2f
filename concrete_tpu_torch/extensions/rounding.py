"""round_bit_pattern / truncate_bit_pattern + Auto adjusters.

Reference: frontends/concrete-python/concrete/fhe/extensions/
round_bit_pattern.py:42,159 and truncate_bit_pattern.py:41,173.

Semantics: clear the `lsbs_to_remove` low bits (rounding to nearest for
round_bit_pattern, toward the floor for truncate).  When every consumer is a
table lookup, the rounding FUSES into the consumer PBS (the reference's
ProcessRounding, mlir/processors/process_rounding.py:17): the LUT is built
at the reduced width p - lsbs and the PBS's modulus switch performs the
rounding for free — making the TLU *cheaper* than unrounded, instead of
costing an extra full-precision PBS.  Non-fusable uses (arithmetic on the
rounded value, or returning it) fall back to one explicit TLU
(transforms.process_rounding demotes them).
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer


class _AdjustingState:
    active = False


_ADJUSTING = _AdjustingState()


class AutoRounder:
    """Chooses lsbs_to_remove from inputset bounds so that `target_msbs`
    significant bits remain (reference AutoRounder, round_bit_pattern.py:159).

    Two call forms of `adjust`, like the reference:

    - `rounder.adjust(value)` observes one clear value;
    - `AutoRounder.adjust(function, inputset)` runs the *clear* function
      over the inputset, letting every AutoRounder used inside observe its
      own input (round_bit_pattern records values in adjust mode).  Two
      passes handle chained rounders (a rounder downstream of another sees
      post-rounding values; lsbs only grow, so the second pass converges).
    """

    def __init__(self, target_msbs: int = 6):
        self.target_msbs = target_msbs
        self.lsbs_to_remove = 0
        self.is_adjusted = False
        self._max_bit_width = 0

    def adjust(self, value):
        if not isinstance(self, AutoRounder):
            # static form: AutoRounder.adjust(function, inputset)
            return _adjust_in_function(self, value)
        arr = np.asarray(value)
        hi = int(np.abs(arr).max()) if arr.size else 0
        width = max(hi.bit_length(), 1)
        self._max_bit_width = max(self._max_bit_width, width)
        self.lsbs_to_remove = max(self._max_bit_width - self.target_msbs, 0)
        self.is_adjusted = True
        return None


def _adjust_in_function(function, inputset) -> None:
    """Run the clear function over the inputset in adjust mode (reference
    round_bit_pattern.py:74 AutoRounder.adjust)."""
    fn = getattr(function, "function", function)  # unwrap @fhe.compiler
    if _ADJUSTING.active:
        raise RuntimeError("AutoRounders cannot be adjusted recursively")
    samples = list(inputset)
    if not samples:
        raise ValueError(
            "AutoRounders cannot be adjusted with an empty inputset")
    _ADJUSTING.active = True
    try:
        for _ in range(2):
            for sample in samples:
                if not isinstance(sample, tuple):
                    sample = (sample,)
                fn(*sample)
    finally:
        _ADJUSTING.active = False


class AutoTruncator(AutoRounder):
    """Reference truncate_bit_pattern.py:173."""


def _resolve_lsbs(lsbs_to_remove, x=None) -> int:
    if isinstance(lsbs_to_remove, AutoRounder):
        if (_ADJUSTING.active and x is not None
                and not isinstance(x, Tracer)):
            lsbs_to_remove.adjust(x)   # observe this clear input
        return lsbs_to_remove.lsbs_to_remove
    return int(lsbs_to_remove)


def _pattern_node(x, name: str, fn, lsbs: int):
    def evaluator(v):
        return np.vectorize(fn, otypes=[np.int64])(np.asarray(v))

    output = Tracer._infer_output(name, evaluator, [x])
    return Tracer._generic(name, [x], evaluator, output,
                           function=fn, lsbs_to_remove=lsbs)


def round_bit_pattern(x, lsbs_to_remove):
    """Round to the nearest multiple of 2^lsbs_to_remove."""
    lsbs = _resolve_lsbs(lsbs_to_remove, x)
    if lsbs == 0:
        return x
    half = 1 << (lsbs - 1)
    step = 1 << lsbs

    def fn(v):
        return ((int(v) + half) // step) * step

    if not isinstance(x, Tracer):
        return np.vectorize(fn, otypes=[np.int64])(np.asarray(x))
    return _pattern_node(x, "round_bit_pattern", fn, lsbs)


def truncate_bit_pattern(x, lsbs_to_remove):
    """Clear the low lsbs_to_remove bits (truncate toward -inf on the raw
    bit pattern, matching the reference's bitwise semantics)."""
    lsbs = _resolve_lsbs(lsbs_to_remove, x)
    if lsbs == 0:
        return x

    def fn(v):
        return (int(v) >> lsbs) << lsbs

    if not isinstance(x, Tracer):
        return np.vectorize(fn, otypes=[np.int64])(np.asarray(x))
    return _pattern_node(x, "truncate_bit_pattern", fn, lsbs)
