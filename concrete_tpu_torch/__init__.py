"""concrete_tpu_torch: the PyTorch/CUDA port of concrete_tpu.

Serves compiled circuits (deployment archives written by the JAX package's
``Server.save``) on an NVIDIA Hopper card: ``Server.load`` + ``Server.run``
on the device, ``Client`` keygen/encrypt/decrypt on the host.  The blind
rotate runs on hand-written CUDA kernels (``csrc/``, built with nvcc at
first use), in one of three forms:

- a banded key at a batch above ``core.kernels.LATENCY_BATCH_MAX``: a host
  loop of kernel A (rotate, decompose, int8 limbs) and kernel B (the
  banded int8 external product on Hopper's tensor cores, shift-added into
  the accumulator), or kernel 9 and the recombine in the JAX package's
  "pallas" mode;
- a banded key at a batch of at most ``LATENCY_BATCH_MAX``: one launch of
  the persistent ``blind_rotate_latency`` kernel for every step (kernel 1's
  digits, kernel 9's latency-form product and the recombine in its body),
  or at shapes it does not take, a host loop of those three kernels;
- a fused key (the CRT-NTT form): a host loop of kernel 1, kernel 3 (the
  external product by NTTs modulo three primes) and kernel 4 (Garner).

Their plain PyTorch versions serve CPU tensors.  The package imports
neither JAX nor ``concrete_tpu``.
"""

from concrete_tpu_torch.compilation import (Client, EvaluationKeys, Keys,
                                            Server)
from concrete_tpu_torch.params import CryptoParams

__all__ = ["Client", "CryptoParams", "EvaluationKeys", "Keys", "Server"]
