"""Compilation configuration.

Counterpart of ``concrete_tpu/compilation/configuration.py``: every field,
default, enum and the ``fork`` semantics of the JAX package (which mirrors
the upstream Configuration, frontends/concrete-python/concrete/fhe/
compilation/configuration.py:954), so that one configuration chooses the
same parameters in both packages.  Three classes of fields:

- **effective**: change compilation here (p_error, strategies,
  single_precision, processors, restrictions, simulate_encrypt_run_decrypt,
  auto_schedule_run, show_*...).
- **accepted and ignored**, as in the JAX package: the upstream toggles of
  hand-written parallelism (loop_parallelize, dataflow_parallelize,
  auto_parallelize) and the fields the JAX package accepts and never reads
  (device_batch_size, mesh_shape and others, documented per field).
- **unsupported**: use_gpu raises, as in the JAX package; the port's
  device comes from the ``device`` argument of ``compile`` / ``Circuit``.

Unknown kwargs are rejected, and `fork(**overrides)` returns a modified
copy, exactly like the reference.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Union


class ParameterSelectionStrategy(enum.Enum):
    """V0 = worst-case atomic pattern; MONO = one keyset sized by every
    (precision, norm2) pattern; MULTI = per-precision partitions with
    conversion keyswitches (reference V0Parameters.cpp:121-143)."""
    V0 = "v0"
    MONO = "mono"
    MULTI = "multi"


class MultiParameterStrategy(enum.Enum):
    """How MULTI cuts partitions (reference optimizer partition_cut.rs):
    by TLU input precision, or by (precision, norm2) pairs.
    PRECISION_AND_NORM2 additionally splits same-width encoding classes
    whose norm2 buckets (ceil(log2 norm2)) differ, so low-norm2 classes
    get their own cheaper keyset (widths.assign_norm2_partitions)."""
    PRECISION = "precision"
    PRECISION_AND_NORM2 = "precision_and_norm2"


class ComparisonStrategy(enum.Enum):
    """Lowering strategies for eint comparisons (reference mlir/context.py
    :880 catalog).  ONE_TLU_PROMOTED = subtraction trick on the promoted
    difference (the default here); CHUNKED = split wide operands into
    chunks compared pairwise (used automatically above the native width)."""
    ONE_TLU_PROMOTED = "one-tlu-promoted"
    CHUNKED = "chunked"


class BitwiseStrategy(enum.Enum):
    ONE_TLU_PROMOTED = "one-tlu-promoted"
    CHUNKED = "chunked"


class MultivariateStrategy(enum.Enum):
    PROMOTED = "promoted"      # pack operands into one TLU index
    CHUNKED = "chunked"


class MinMaxStrategy(enum.Enum):
    ONE_TLU_PROMOTED = "one-tlu-promoted"
    CHUNKED = "chunked"


class Exactness(enum.Enum):
    """Rounding semantics (reference round_bit_pattern): EXACT matches
    round-half-up exactly; APPROXIMATE lets truncation skip its half-step
    bias correction (one clear addition cheaper, off-by-half on ties)."""
    EXACT = "exact"
    APPROXIMATE = "approximate"


class SecurityLevel(enum.IntEnum):
    """Supported security levels (tools/parameter-curves commits 128/132)."""
    SECURITY_128_BITS = 128
    SECURITY_132_BITS = 132


@dataclasses.dataclass
class ApproximateRoundingConfig:
    """Fine-tuning for Exactness.APPROXIMATE rounding (reference
    configuration.py ApproximateRoundingConfig)."""
    logical_clipping: bool = True
    approximate_clipping_start_precision: int = 5
    reduce_precision_after_approximate_clipping: bool = True
    symetrize_deltas: bool = True


@dataclasses.dataclass(frozen=True)
class RangeRestriction:
    """Restrict the optimizer's search space (reference
    optimize/restriction.rs RangeRestriction).  Empty sequences = no
    restriction on that axis."""
    internal_lwe_dimensions: tuple = ()       # allowed n_small values
    glwe_log_polynomial_sizes: tuple = ()     # allowed log2(N)
    glwe_dimensions: tuple = ()               # allowed k
    pbs_level_count: tuple = ()               # allowed BR levels
    pbs_base_log: tuple = ()                  # allowed BR base logs
    ks_level_count: tuple = ()                # allowed KS levels
    ks_base_log: tuple = ()                   # allowed KS base logs


@dataclasses.dataclass
class KeysetRestriction:
    """Pin the exact keyset shape (reference restriction.rs
    KeysetRestriction): compilation must reuse these CryptoParams."""
    params: object = None                     # a CryptoParams


@dataclasses.dataclass
class Configuration:
    # -- diagnostics / artifacts ------------------------------------------
    verbose: bool = False
    show_graph: Optional[bool] = None
    show_bit_width_constraints: Optional[bool] = None   # prints width classes
    show_bit_width_assignments: Optional[bool] = None   # prints node widths
    show_assigned_graph: Optional[bool] = None
    show_mlir: Optional[bool] = None      # prints Server.lowering_text (the
    #                                       IR analog of the MLIR dump)
    show_optimizer: Optional[bool] = None
    show_statistics: Optional[bool] = None
    dump_artifacts_on_unexpected_failures: bool = True
    show_progress: bool = False
    progress_title: str = ""
    progress_tag: Union[bool, int] = False
    compiler_debug_mode: bool = False     # keep intermediate lowerings
    compiler_verbose_mode: bool = False   # print lowering stages

    # -- safety / keys -----------------------------------------------------
    enable_unsafe_features: bool = False
    use_insecure_key_cache: bool = False
    insecure_key_cache_location: Optional[str] = None
    compress_evaluation_keys: bool = False    # accepted, unused (as in the
    #                                           JAX package)
    compress_input_ciphertexts: bool = False
    security_level: Union[int, SecurityLevel] = SecurityLevel.SECURITY_128_BITS

    # -- error budgets / parameter search ---------------------------------
    p_error: Optional[float] = None            # per-PBS error bound
    global_p_error: Optional[float] = None     # circuit-wide error bound
    # MULTI by default like the reference (V0Parameters.cpp dag-multi is
    # the shipped default); circuits with one partition resolve to the
    # identical mono solution (plan_partitions returns None)
    parameter_selection_strategy: ParameterSelectionStrategy = \
        ParameterSelectionStrategy.MULTI
    multi_parameter_strategy: MultiParameterStrategy = \
        MultiParameterStrategy.PRECISION
    single_precision: bool = False   # force every value to the global width
    #                                  (disables multi-precision encoding)
    range_restriction: Optional[RangeRestriction] = None
    keyset_restriction: Optional[KeysetRestriction] = None

    # -- parallelism (accepted for API parity and ignored, as in the JAX
    #    package) ---------------------------------------------------------
    loop_parallelize: bool = True
    dataflow_parallelize: bool = False
    auto_parallelize: bool = False
    use_gpu: bool = False            # unsupported: raises if True
    auto_schedule_run: bool = False  # run() returns a Future (thread pool)

    # -- strategy preferences (reference context.py catalog) --------------
    comparison_strategy_preference: list = dataclasses.field(
        default_factory=list)
    bitwise_strategy_preference: list = dataclasses.field(
        default_factory=list)
    multivariate_strategy_preference: list = dataclasses.field(
        default_factory=list)
    min_max_strategy_preference: list = dataclasses.field(
        default_factory=list)
    shifts_with_promotion: bool = True
    relu_on_bits_threshold: int = 7    # width at which relu switches to the
    #                                    bit-extraction lowering
    relu_on_bits_chunk_size: int = 3
    if_then_else_chunk_size: int = 3
    optim_lsbs_with_lut: bool = True

    # -- rounding ----------------------------------------------------------
    auto_adjust_rounders: bool = False
    auto_adjust_truncators: bool = False
    rounding_exactness: Exactness = Exactness.EXACT
    approximate_rounding_config: ApproximateRoundingConfig = \
        dataclasses.field(default_factory=ApproximateRoundingConfig)

    # -- TLU optimization --------------------------------------------------
    optimize_tlu_based_on_measured_bounds: bool = False   # inherent here:
    #   widths always come from measured bounds (compilation/widths.py), so
    #   every TLU is already sized to what the inputset actually produced
    enable_tlu_fusing: bool = True
    print_tlu_fusing: bool = False
    optimize_tlu_based_on_original_bit_width: Union[bool, int] = 8

    # -- simulation / execution toggles -----------------------------------
    fhe_simulation: bool = False
    fhe_execution: bool = True
    simulate_encrypt_run_decrypt: bool = False
    detect_overflow_in_simulation: bool = False

    # -- dynamic indexing checks (dynamic tables validate their size
    #    against the index width at compile time — executor.py dynamic_tlu;
    #    encrypted-index fancy ops beyond that are rejected at trace) ------
    dynamic_indexing_check_out_of_bounds: bool = True
    dynamic_assignment_check_out_of_bounds: bool = True

    # -- composition / processors -----------------------------------------
    composable: bool = False
    additional_pre_processors: list = dataclasses.field(default_factory=list)
    additional_post_processors: list = dataclasses.field(default_factory=list)

    # -- the JAX package's device fields (accepted and ignored there too) --
    device_batch_size: Optional[int] = None
    mesh_shape: Optional[tuple] = None
    # forced crypto parameters (bypass the optimizer; e.g. for benches)
    forced_parameters: Optional[object] = None
    # forced WoP-PBS gadgets (cbs_level, cbs_base_log, pfks_level,
    # pfks_base_log) — bypass choose_wop_gadgets (tests/benches)
    forced_wop_parameters: Optional[tuple] = None

    def __post_init__(self):
        if self.p_error is None and self.global_p_error is None:
            self.p_error = 6.3e-5   # reference default target (v0 tables)
        # accept enums as strings/ints, like the reference Configuration
        if isinstance(self.parameter_selection_strategy, str):
            self.parameter_selection_strategy = \
                ParameterSelectionStrategy(self.parameter_selection_strategy)
        if isinstance(self.multi_parameter_strategy, str):
            self.multi_parameter_strategy = \
                MultiParameterStrategy(self.multi_parameter_strategy)
        if isinstance(self.rounding_exactness, str):
            self.rounding_exactness = Exactness(self.rounding_exactness)
        if isinstance(self.security_level, SecurityLevel):
            self.security_level = int(self.security_level)
        if self.use_gpu:
            raise ValueError(
                "use_gpu is not supported: the port runs on the card unless "
                "asked for the CPU; pass device= to compile or Circuit")
        if self.keyset_restriction is not None \
                and self.keyset_restriction.params is not None \
                and self.forced_parameters is None:
            self.forced_parameters = self.keyset_restriction.params

    def fork(self, **overrides) -> "Configuration":
        known = {f.name for f in dataclasses.fields(self)}
        unknown = set(overrides) - known
        if unknown:
            raise TypeError(f"unexpected configuration option(s): {unknown}")
        return dataclasses.replace(self, **overrides)
