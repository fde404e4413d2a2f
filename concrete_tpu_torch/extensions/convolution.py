"""conv / maxpool over encrypted tensors with clear weights.

Reference: frontends/concrete-python/concrete/fhe/extensions/convolution.py
and maxpool.py (FHELinalg.conv2d / maxpool2d ops).  Convolution with clear
weights is a leveled op (u64 dot products over ciphertext components);
maxpool reduces with the max TLU chain.
"""

from __future__ import annotations

import numpy as np

from concrete_tpu_torch.tracing.tracer import Tracer


def conv(x, weight, bias=None, strides=(1, 1), padding=(0, 0)):
    """2-D convolution, NCHW x OIHW, encrypted input x clear weight.

    Traced as a generic node; the executor lowers it to u64 einsums (the
    batched linear path), costing no PBS.
    """
    weight = np.asarray(weight, dtype=np.int64)
    if bias is not None:
        bias = np.asarray(bias, dtype=np.int64)
    strides = tuple(strides)
    padding = tuple(padding)

    def evaluator(v):
        v = np.asarray(v, dtype=np.int64)
        n, c, h, w = v.shape
        o, i, kh, kw = weight.shape
        ph, pw = padding
        v = np.pad(v, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
        oh = (h + 2 * ph - kh) // strides[0] + 1
        ow = (w + 2 * pw - kw) // strides[1] + 1
        out = np.zeros((n, o, oh, ow), dtype=np.int64)
        for yy in range(oh):
            for xx in range(ow):
                patch = v[:, :, yy * strides[0]:yy * strides[0] + kh,
                          xx * strides[1]:xx * strides[1] + kw]
                out[:, :, yy, xx] = np.einsum("ncij,ocij->no", patch, weight)
        if bias is not None:
            out += bias[None, :, None, None]
        return out

    if not isinstance(x, Tracer):
        return evaluator(x)
    output = Tracer._infer_output("conv", evaluator, [x])
    return Tracer._generic("conv", [x], evaluator, output, weight=weight,
                           bias=bias, strides=strides, padding=padding)


def maxpool(x, kernel_shape, strides=None):
    """2-D max pooling via the maximum TLU chain (one PBS pair per reduction
    step).  Reference maxpool.py semantics, NCHW."""
    kh, kw = kernel_shape
    strides = tuple(strides) if strides is not None else (kh, kw)
    if not isinstance(x, Tracer):
        v = np.asarray(x)
        n, c, h, w = v.shape
        oh = (h - kh) // strides[0] + 1
        ow = (w - kw) // strides[1] + 1
        out = np.full((n, c, oh, ow), -(1 << 62), dtype=np.int64)
        for yy in range(oh):
            for xx in range(ow):
                patch = v[:, :, yy * strides[0]:yy * strides[0] + kh,
                          xx * strides[1]:xx * strides[1] + kw]
                out[:, :, yy, xx] = patch.max(axis=(2, 3))
        return out
    n, c, h, w = x.shape
    oh = (h - kh) // strides[0] + 1
    ow = (w - kw) // strides[1] + 1
    result = None
    for dy in range(kh):
        for dx in range(kw):
            window = x[:, :, dy:dy + oh * strides[0]:strides[0],
                       dx:dx + ow * strides[1]:strides[1]]
            result = window if result is None else np.maximum(result, window)
    return result
