"""concrete_tpu_torch: the PyTorch/CUDA port of concrete_tpu.

Compiles and serves circuits on an NVIDIA Hopper card, under the JAX
package's spelling:

    import concrete_tpu_torch as fhe

    @fhe.compiler({"x": "encrypted", "y": "encrypted"})
    def add(x, y):
        return x + y

    circuit = add.compile([(2, 3), (0, 0), (7, 7)])
    assert circuit.encrypt_run_decrypt(2, 6) == 8

Compiling (trace, transforms, the multi-partition planner and the ``v0``
parameter search) is host code and chooses the JAX package's graph,
parameters and ``ClientSpecs``; ``Server.save`` writes its archives and
``Server.load`` reads them.  ``Circuit.run`` / ``Server.run`` run on the
card unless the caller passes ``device="cpu"``; ``Client``
keygen/encrypt/decrypt run on the host.  The blind
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

import sys as _sys

from concrete_tpu_torch.version import __version__
from concrete_tpu_torch.compilation import (Circuit, Client, Compiler,
                                            Configuration, EvaluationKeys,
                                            Keys, Server, circuit, compiler)
from concrete_tpu_torch.compilation.configuration import (
    ApproximateRoundingConfig, BitwiseStrategy, ComparisonStrategy,
    Exactness, KeysetRestriction, MinMaxStrategy, MultiParameterStrategy,
    MultivariateStrategy, ParameterSelectionStrategy, RangeRestriction,
    SecurityLevel)
from concrete_tpu_torch.dtypes import Float, Integer
from concrete_tpu_torch.extensions import (AutoRounder, AutoTruncator,
                                           LookupTable, hint, multivariate,
                                           round_bit_pattern, tag,
                                           truncate_bit_pattern, univariate)
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.representation import Graph, Node, Operation
from concrete_tpu_torch.tracing import Tracer
from concrete_tpu_torch.tracing import typing as _typing

for _w in range(1, 65):
    setattr(_sys.modules[__name__], f"uint{_w}", getattr(_typing, f"uint{_w}"))
    setattr(_sys.modules[__name__], f"int{_w}", getattr(_typing, f"int{_w}"))
tensor = _typing.tensor
f32 = _typing.f32
f64 = _typing.f64

__all__ = [
    "__version__",
    "Circuit", "Client", "Compiler", "Configuration", "EvaluationKeys",
    "Keys", "Server", "circuit", "compiler",
    "ApproximateRoundingConfig", "BitwiseStrategy", "ComparisonStrategy",
    "Exactness", "KeysetRestriction", "MinMaxStrategy",
    "MultiParameterStrategy", "MultivariateStrategy",
    "ParameterSelectionStrategy", "RangeRestriction", "SecurityLevel",
    "CryptoParams", "Float", "Integer", "Graph", "Node", "Operation",
    "Tracer", "tensor", "f32", "f64",
    "AutoRounder", "AutoTruncator", "LookupTable", "hint", "multivariate",
    "round_bit_pattern", "tag", "truncate_bit_pattern", "univariate",
]
