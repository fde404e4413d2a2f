"""The extensions the port's tracer and compiler need (counterparts of
``concrete_tpu/extensions``; the other eight files are ROADMAP queue 1
item 5)."""

from concrete_tpu_torch.extensions.table import LookupTable
from concrete_tpu_torch.extensions.univariate import univariate
from concrete_tpu_torch.extensions.multivariate import multivariate
from concrete_tpu_torch.extensions.rounding import (AutoRounder, AutoTruncator,
                                                    round_bit_pattern,
                                                    truncate_bit_pattern)
from concrete_tpu_torch.extensions.tag import hint, tag

__all__ = ["LookupTable", "univariate", "multivariate", "AutoRounder",
           "AutoTruncator", "round_bit_pattern", "truncate_bit_pattern",
           "tag", "hint"]
