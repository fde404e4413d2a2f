"""Encrypted quantized-MLP inference (Concrete-ML-style workload).

BASELINE config #5: an MNIST-style quantized MLP run under FHE, the leveled
matmuls on ciphertext tensors and the activations as batched PBS.  Weights
are small signed integers (post-training quantization); activations use a
rounded ReLU table to keep the accumulator precision bounded.

Counterpart of ``concrete_tpu/models/mlp.py``: the same weights from the
same seed and the same traced function, so both packages compile it to the
same circuit; ``compile`` also takes the port's ``device``.
"""

from __future__ import annotations

import numpy as np

import concrete_tpu_torch as fhe


class QuantizedMLP:
    """d_in -> d_hidden -> d_out MLP with integer weights.

    activation_bits bounds every activation via a requantizing TLU:
    relu(acc) >> shift, the standard Concrete-ML pattern.
    """

    def __init__(self, d_in: int = 8, d_hidden: int = 4, d_out: int = 2,
                 weight_bits: int = 2, activation_bits: int = 2,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        half = 1 << (weight_bits - 1)
        self.w1 = rng.integers(-half, half, (d_in, d_hidden))
        self.w2 = rng.integers(-half, half, (d_hidden, d_out))
        self.d_in = d_in
        self.activation_bits = activation_bits
        acc_max = int(np.abs(self.w1).sum(axis=0).max()) * \
            ((1 << activation_bits) - 1)
        self.shift = max(acc_max.bit_length() - activation_bits, 0)

    def infer_clear(self, x: np.ndarray) -> np.ndarray:
        h = np.maximum(x @ self.w1, 0) >> self.shift
        return h @ self.w2

    def compile(self, configuration=None, inputset_size: int = 30,
                seed: int = 1, batch_size: int = None, device=None):
        """Compile for single samples (d_in,) or batches (batch_size, d_in),
        to run on `device` (None means CUDA)."""
        rng = np.random.default_rng(seed)
        a_max = (1 << self.activation_bits) - 1
        w1, w2, shift = self.w1, self.w2, self.shift

        @fhe.compiler({"x": "encrypted"})
        def forward(x):
            acc = x @ w1
            h = fhe.univariate(lambda v: max(int(v), 0) >> shift)(acc)
            return h @ w2

        shape = (self.d_in,) if batch_size is None \
            else (batch_size, self.d_in)
        inputset = [rng.integers(0, a_max + 1, shape)
                    for _ in range(inputset_size)]
        return forward.compile(inputset, configuration, device=device)
