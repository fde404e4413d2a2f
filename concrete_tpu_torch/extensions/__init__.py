"""The extensions of the port's tracer and compiler (counterparts of
``concrete_tpu/extensions``).  ``bits`` lowers to ``extract_bits`` and
``crt.crt_tlu`` to ``crt_tlu``, both served by WoP-PBS
(``core/kernels_wop.py``); ``bigint`` is ROADMAP queue 1 item 5."""

from concrete_tpu_torch.extensions.table import LookupTable
from concrete_tpu_torch.extensions.univariate import univariate
from concrete_tpu_torch.extensions.multivariate import multivariate
from concrete_tpu_torch.extensions.basics import (zero, zeros, one, ones,
                                                  zeros_like, ones_like,
                                                  constant, identity, refresh)
from concrete_tpu_torch.extensions.rounding import (AutoRounder, AutoTruncator,
                                                    round_bit_pattern,
                                                    truncate_bit_pattern)
from concrete_tpu_torch.extensions.bits import bits
from concrete_tpu_torch.extensions.control import if_then_else, mux, relu
from concrete_tpu_torch.extensions.convolution import conv, maxpool
from concrete_tpu_torch.extensions.tag import tag, hint
from concrete_tpu_torch.extensions.tracing_ops import trace
from concrete_tpu_torch.extensions.array_ops import array, inputset

__all__ = ["LookupTable", "univariate", "multivariate", "zero", "zeros",
           "one", "ones", "zeros_like", "ones_like", "constant",
           "identity", "refresh",
           "AutoRounder", "AutoTruncator", "round_bit_pattern",
           "truncate_bit_pattern", "bits", "if_then_else", "mux", "relu",
           "conv", "maxpool", "tag", "hint", "trace", "array", "inputset"]
