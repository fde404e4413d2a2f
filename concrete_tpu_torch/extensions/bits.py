"""fhe.bits — bit extraction from encrypted integers.

Reference: frontends/concrete-python/concrete/fhe/extensions/bits.py:19,155
(`fhe.bits(x)[i]`, slices of bits) with the lsb-cascade lowering of
mlir/context.py:2423: extraction costs ~2 small sign-PBS per peeled bit
(kernels_wop.extract_bits_to), not one full-width TLU per bit.
"""

from __future__ import annotations

import numpy as np


def _bits_node(x, positions: tuple[int, ...]):
    """Graph node reassembling the selected bits as an unsigned integer:
    out = sum_j bit[positions[j]] << j (executor: extract_bits cascade)."""
    from concrete_tpu_torch.tracing.tracer import Tracer

    def evaluator(v):
        v = np.asarray(v, dtype=np.int64)
        out = np.zeros_like(v)
        for j, b in enumerate(positions):
            out |= ((v >> np.int64(b)) & np.int64(1)) << np.int64(j)
        return out

    output = Tracer._infer_output("extract_bits", evaluator, [x])
    return Tracer._generic("extract_bits", [x], evaluator, output,
                           positions=tuple(int(p) for p in positions))


class Bits:
    def __init__(self, value):
        self.value = value

    def __getitem__(self, index):
        if isinstance(index, int):
            if index < 0:
                raise ValueError(
                    "negative bit indices require a known bit width; "
                    "use non-negative indices")
            return _bits_node(self.value, (index,))
        if isinstance(index, slice):
            start = index.start or 0
            stop = index.stop
            step = index.step or 1
            if stop is None:
                raise ValueError("bit slices need an explicit stop")
            sel = tuple(range(start, stop, step))
            if not sel:
                raise ValueError(f"empty bit slice: {index!r}")
            return _bits_node(self.value, sel)
        raise TypeError(f"unsupported bit index: {index!r}")


def bits(x) -> Bits:
    return Bits(x)
