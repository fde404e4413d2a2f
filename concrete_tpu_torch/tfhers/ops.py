"""Tracing ops: TFHE-rs radix values <-> native encrypted integers.

Counterpart of ``concrete_tpu/tfhers/ops.py``, on the port's tracer,
``univariate`` and ``hint``: one function traces to the JAX package's
graph.

Reference: tfhers/tracing.py to_native/from_native and the compiler lowering
mlir/converter.py:937-1009 (per-limb keyswitch + PBS partition changes).

Here: a TFHE-rs value inside a circuit is its vector of block values
(shape (..., n_blocks), LSB-first).  to_native recombines blocks into one
native integer (leveled dot with radix weights after per-block message
extraction); from_native splits a native integer into blocks via one TLU per
block.

Signedness: TFHE-rs radix integers are two's-complement; the top block's
extraction TLU maps its content to a *signed* contribution (subtracting
2^(s+1) when the sign bit s is set), so the recombined native value is the
true signed integer, not its unsigned image.
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tfhers.dtypes import TFHERSIntegerType
from concrete_tpu_torch.tracing.tracer import Tracer


def _top_block_range(dtype: TFHERSIntegerType) -> int:
    """Significant bits held by the MSB block (bit_width may not be a
    multiple of msg_width)."""
    used = (dtype.n_blocks - 1) * dtype.msg_width
    return dtype.bit_width - used


def _block_cleaner(dtype: TFHERSIntegerType, block_idx: int):
    """The per-block message-extraction function: reduce mod msg_modulus;
    for the MSB block of a signed type, also fold in the sign."""
    msg_mod = dtype.msg_modulus
    if dtype.is_signed and block_idx == dtype.n_blocks - 1:
        top_bits = _top_block_range(dtype)
        sign = 1 << (top_bits - 1)
        span = 1 << top_bits

        def clean(v):
            u = int(v) % msg_mod
            return u - span if u >= sign else u
        return clean
    return lambda v: int(v) % msg_mod


def to_native(value, dtype: TFHERSIntegerType):
    """blocks (..., n_blocks) -> native integer (signed when the dtype is).

    Blocks may carry garbage in their carry space; each block is first
    reduced mod msg_modulus by a TLU, then recombined with radix weights.
    The MSB block of signed types contributes its two's-complement signed
    value, so e.g. int8 blocks of -3 recombine to -3, not 253.
    """
    msg_mod = dtype.msg_modulus
    weights = np.array([msg_mod ** i for i in range(dtype.n_blocks)],
                       dtype=np.int64)
    if isinstance(value, (tuple, list)):
        # from_native's traced form: one tracer per block
        from concrete_tpu_torch.extensions.univariate import univariate
        out = None
        for i, block in enumerate(value):
            cleaner = _block_cleaner(dtype, i)
            clean = univariate(cleaner)(block) \
                if isinstance(block, Tracer) else \
                np.vectorize(cleaner)(np.asarray(block))
            term = clean * int(weights[i])
            out = term if out is None else out + term
        return out
    if not isinstance(value, Tracer):
        blocks = np.asarray(value) % msg_mod
        out = (blocks * weights).sum(axis=-1)
        if dtype.is_signed:
            half = 1 << (dtype.bit_width - 1)
            out = out - (out >= half) * (1 << dtype.bit_width)
        return out
    from concrete_tpu_torch.extensions.univariate import univariate
    if dtype.is_signed:
        # per-block TLUs (the MSB block's table is signed)
        blocks = [value[..., i] for i in range(dtype.n_blocks)]
        return to_native(blocks, dtype)
    clean = univariate(lambda v: int(v) % msg_mod)(value)
    return np.dot(clean, weights)


def from_native(value, dtype: TFHERSIntegerType):
    """native integer -> blocks (..., n_blocks), one TLU per block.

    Each block is hinted to msg+carry bits so its native encoding delta
    equals the TFHE-rs delta (64 - msg - carry - 1): Bridge.export_value
    can then ship the raw ciphertexts without rescaling."""
    msg_mod = dtype.msg_modulus
    w = dtype.msg_width
    if not isinstance(value, Tracer):
        v = np.asarray(value) % (1 << dtype.bit_width)
        return np.stack([(v >> (i * w)) & (msg_mod - 1)
                         for i in range(dtype.n_blocks)], axis=-1)
    from concrete_tpu_torch.extensions.tag import hint
    from concrete_tpu_torch.extensions.univariate import univariate
    span = 1 << dtype.bit_width
    blocks = []
    for i in range(dtype.n_blocks):
        block = univariate(
            lambda v, i=i: ((int(v) % span) >> (i * w)) & (msg_mod - 1)
        )(value)
        blocks.append(hint(block,
                           bit_width=dtype.msg_width + dtype.carry_width))
    # one tracer per radix block; to_native accepts this tuple directly
    return tuple(blocks) if len(blocks) > 1 else blocks[0]
