"""concrete_tpu_torch: the PyTorch/CUDA port of concrete_tpu.

Serves compiled circuits (deployment archives written by the JAX package's
``Server.save``) on an NVIDIA Hopper card: ``Server.load`` + ``Server.run``
on the device, ``Client`` keygen/encrypt/decrypt on the host.  The blind
rotate runs on two hand-written CUDA kernels (``csrc/``); their plain
PyTorch versions serve CPU tensors.  The package imports neither JAX nor
``concrete_tpu``.
"""

from concrete_tpu_torch.compilation import (Client, EvaluationKeys, Keys,
                                            Server)
from concrete_tpu_torch.params import CryptoParams

__all__ = ["Client", "CryptoParams", "EvaluationKeys", "Keys", "Server"]
