"""concrete_tpu_torch: the PyTorch/CUDA port of concrete_tpu.

Compiles and serves circuits on an NVIDIA Hopper card, under the JAX
package's spelling:

    import concrete_tpu_torch as fhe

    @fhe.compiler({"x": "encrypted", "y": "encrypted"})
    def add(x, y):
        return x + y

    circuit = add.compile([(2, 3), (0, 0), (7, 7)])
    assert circuit.encrypt_run_decrypt(2, 6) == 8

Modules (``@fhe.module()`` with ``@fhe.function`` methods) compile
functions that share one keyset, so that one function's output ciphertext
feeds another's input without decryption, under a composition policy
(``AllComposable``, ``NotComposable``, ``Wired``).  ``simulate`` runs a
circuit's noise-accurate plaintext simulation on the host; ``run_async``
and ``DataflowScheduler`` run calls as a dataflow graph on a thread pool;
``tfhers`` imports and exports TFHE-rs radix ciphertexts; ``python -m
concrete_tpu_torch`` is the command line (compile, inspect, keygen, run).

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

import enum as _enum
import sys as _sys

from concrete_tpu_torch.version import __version__
from concrete_tpu_torch.compilation import (Circuit, Client, Compiler,
                                            Configuration, EvaluationKeys,
                                            Keys, Server, circuit, compiler,
                                            function, module)
from concrete_tpu_torch.compilation import FheFunction as Function
from concrete_tpu_torch.compilation import FheModule as Module
from concrete_tpu_torch.compilation.artifacts import (
    DebugArtifacts, FunctionDebugArtifacts, ModuleDebugArtifacts)
from concrete_tpu_torch.compilation.composition import (
    AllComposable, AllInputs, AllOutputs, CompositionPolicy, Input,
    NotComposable, Output, Wire, Wired)
from concrete_tpu_torch.compilation.scheduler import DataflowScheduler
from concrete_tpu_torch.compilation.configuration import (
    ApproximateRoundingConfig, BitwiseStrategy, ComparisonStrategy,
    Exactness, KeysetRestriction, MinMaxStrategy, MultiParameterStrategy,
    MultivariateStrategy, ParameterSelectionStrategy, RangeRestriction,
    SecurityLevel)
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.compilation.value import TransportValue, Value
from concrete_tpu_torch.dtypes import Float, Integer
from concrete_tpu_torch.extensions import (AutoRounder, AutoTruncator,
                                           LookupTable, array, bits,
                                           constant, conv,
                                           hint, identity, if_then_else,
                                           inputset, maxpool, multivariate,
                                           mux, one, ones, ones_like, refresh,
                                           relu, round_bit_pattern, tag,
                                           trace, truncate_bit_pattern,
                                           univariate, zero, zeros,
                                           zeros_like)
from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.representation import Graph, Node, Operation
from concrete_tpu_torch.tracing import Tracer
from concrete_tpu_torch.tracing import typing as _typing
from concrete_tpu_torch import tfhers

for _w in range(1, 65):
    setattr(_sys.modules[__name__], f"uint{_w}", getattr(_typing, f"uint{_w}"))
    setattr(_sys.modules[__name__], f"int{_w}", getattr(_typing, f"int{_w}"))
tensor = _typing.tensor
f32 = _typing.f32
f64 = _typing.f64

#: reference configuration.py:24-27 defaults
MAXIMUM_TLU_BIT_WIDTH = 16
DEFAULT_P_ERROR = None
DEFAULT_GLOBAL_P_ERROR = 1 / 100_000


class EncryptionStatus(str, _enum.Enum):
    """Parameter encryption status (reference compilation/status.py)."""
    CLEAR = "clear"
    ENCRYPTED = "encrypted"


class GraphProcessor:
    """Base class for Configuration.additional_pre/post_processors
    (reference representation/GraphProcessor): subclass and implement
    apply(graph)."""

    def apply(self, graph):
        raise NotImplementedError

    def __call__(self, graph):
        return self.apply(graph)


__all__ = [
    "__version__",
    "Circuit", "Client", "Compiler", "Configuration", "EvaluationKeys",
    "Keys", "Server", "circuit", "compiler", "DataflowScheduler",
    "Function", "Module", "function", "module",
    "CompositionPolicy", "AllComposable", "NotComposable", "Wired", "Wire",
    "Input", "Output", "AllInputs", "AllOutputs",
    "DebugArtifacts", "FunctionDebugArtifacts", "ModuleDebugArtifacts",
    "ApproximateRoundingConfig", "BitwiseStrategy", "ComparisonStrategy",
    "Exactness", "KeysetRestriction", "MinMaxStrategy",
    "MultiParameterStrategy", "MultivariateStrategy",
    "ParameterSelectionStrategy", "RangeRestriction", "SecurityLevel",
    "CryptoParams", "Float", "Integer", "Graph", "Node", "Operation",
    "Tracer", "tensor", "tfhers", "f32", "f64",
    "AutoRounder", "AutoTruncator", "LookupTable", "hint", "multivariate",
    "round_bit_pattern", "tag", "truncate_bit_pattern", "univariate",
    "constant", "identity", "trace", "array", "inputset", "refresh", "zero",
    "zeros", "one", "ones", "zeros_like", "ones_like", "bits",
    "if_then_else",
    "mux", "relu", "conv", "maxpool", "ClientSpecs", "Value",
    "TransportValue", "EncryptionStatus", "GraphProcessor",
    "MAXIMUM_TLU_BIT_WIDTH", "DEFAULT_P_ERROR", "DEFAULT_GLOBAL_P_ERROR",
]
