"""Compiler: trace -> measure -> assign widths -> choose parameters -> Circuit.

Reference: frontends/concrete-python/concrete/fhe/compilation/compiler.py:165
(Compiler.compile) and module_compiler.py:34-470 (FunctionDef.evaluate:
trace + bounds + fuse).  Float subgraphs are fused into TLUs by
transforms.run_default_transforms (the analog of compilation/utils.py:208);
univariate/LookupTable cover the explicit-TLU path.

Counterpart of ``concrete_tpu/compilation/compiler.py``: the same trace,
transforms, width assignment, multi-partition planning and parameter
search, so one function compiles to the JAX package's graph, widths,
``CryptoParams`` and ``ClientSpecs``.  Compiling is host code; the
resulting ``Circuit`` runs on ``device`` (None means CUDA).  Table
lookups above the native width compile to WoP-PBS, with the JAX package's
gadget search (``optimizer.v0.choose_wop_gadgets``) or
``forced_wop_parameters``.  ``artifacts`` (a ``DebugArtifacts``) gets the
JAX package's graph, bounds, parameters and statistics files.  A compile is
the span ``compile`` (``utils/telemetry``), its stages ``compile.trace``,
``compile.bounds``, ``compile.optimize`` and ``compile.lower``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from concrete_tpu_torch.compilation.circuit import Circuit
from concrete_tpu_torch.compilation.configuration import Configuration
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.optimizer import optimize_v0_multi
from concrete_tpu_torch.tracing import Tracer
from concrete_tpu_torch.utils import telemetry as tm

#: the span of each stage that ``Configuration.show_progress`` names
_STAGE_SPANS = {"tracing": "compile.trace",
                "transforms + bounds measurement": "compile.bounds",
                "parameter optimization": "compile.optimize",
                "lowering": "compile.lower"}


class Compiler:
    def __init__(self, function: Callable,
                 parameter_encryption_statuses: dict[str, str]):
        self.function = function
        self.parameter_encryption_statuses = parameter_encryption_statuses
        self.configuration = Configuration()

    def compile(self, inputset, configuration: Optional[Configuration] = None,
                artifacts=None, device=None, **kwargs) -> Circuit:
        with tm.span("compile") if tm.on else tm.OFF, tm.Stages() as stages:
            return self._compile(stages, inputset, configuration, artifacts,
                                 device, **kwargs)

    def _compile(self, stages, inputset, configuration, artifacts, device,
                 **kwargs) -> Circuit:
        config = configuration or self.configuration
        if kwargs:
            config = config.fork(**kwargs)

        inputset = list(inputset)
        if not inputset:
            raise ValueError("inputset must not be empty")
        sample = inputset[0]

        def progress(stage: str):
            stages.next(_STAGE_SPANS[stage])
            # Configuration.show_progress (reference compile-progress bar)
            if config.show_progress:
                title = config.progress_title or self.function.__name__
                print(f"[{title}] {stage}", flush=True)

        if config.auto_adjust_rounders or config.auto_adjust_truncators:
            # run the clear function over the inputset so AutoRounders /
            # AutoTruncators observe their inputs before the real trace
            # (reference round_bit_pattern.py:74)
            from concrete_tpu_torch.extensions.rounding import AutoRounder
            AutoRounder.adjust(self.function, inputset)

        progress("tracing")
        graph = Tracer.trace(self.function,
                             self.parameter_encryption_statuses,
                             sample=sample, name=self.function.__name__)
        from concrete_tpu_torch.compilation.configuration import Exactness
        from concrete_tpu_torch.compilation.transforms import \
            run_default_transforms
        from concrete_tpu_torch.compilation.widths import (
            assign_encoding_widths, encoding_width, output_encoding_width,
            tlu_pattern_split)
        run_default_transforms(
            graph, enable_tlu_fusing=config.enable_tlu_fusing,
            print_tlu_fusing=config.print_tlu_fusing,
            approximate_rounding=(config.rounding_exactness
                                  is Exactness.APPROXIMATE))
        for processor in config.additional_pre_processors:
            processor(graph)
        progress("transforms + bounds measurement")
        graph.measure_bounds(inputset)
        graph.update_dtypes_from_bounds()
        from concrete_tpu_torch.compilation.configuration import (
            ComparisonStrategy, MinMaxStrategy)
        from concrete_tpu_torch.compilation.transforms import (
            chunk_wide_comparisons, chunk_wide_minmax)
        # The native limit is N-dependent (mega-case packing): exact
        # under forced parameters, the 8-bit production ceiling else.
        native = 8
        if config.forced_parameters is not None:
            native = min(8, int(config.forced_parameters
                                .polynomial_size).bit_length() - 2)
        prefs = config.comparison_strategy_preference or []
        if ComparisonStrategy.ONE_TLU_PROMOTED not in prefs:
            # chunk comparisons whose promoted difference exceeds the
            # native TLU width (else they would cost a WoP-PBS); explicit
            # ONE_TLU_PROMOTED preference keeps the single wide TLU,
            # explicit CHUNKED chunks even natively-fitting ones
            # (reference context.py:880 strategy catalog)
            chunk_wide_comparisons(
                graph, native_bits=native,
                force=ComparisonStrategy.CHUNKED in prefs)
        mm_prefs = config.min_max_strategy_preference or []
        if MinMaxStrategy.ONE_TLU_PROMOTED not in mm_prefs:
            # same catalog for min/max (reference minimum/maximum
            # MinMaxStrategy): chunk the relu-of-difference when the
            # promoted width would need WoP, or always when explicitly
            # preferred
            chunk_wide_minmax(graph, native_bits=native,
                              force=MinMaxStrategy.CHUNKED in mm_prefs)
        from concrete_tpu_torch.compilation.transforms import \
            chunk_wide_encrypted_shifts
        native_sh = 8
        if config.forced_parameters is not None:
            native_sh = min(8, int(config.forced_parameters
                                   .polynomial_size).bit_length() - 2)
        chunk_wide_encrypted_shifts(graph, native_bits=native_sh)
        widths = assign_encoding_widths(graph,
                                        composable=config.composable)

        p = graph.max_bit_width
        if config.single_precision:
            # pre-multi-precision behavior: every value at the global width
            for node in graph.graph.nodes:
                if node.output.is_encrypted:
                    node.properties["encoding_width"] = p
        for processor in config.additional_post_processors:
            processor(graph)
        if config.verbose or config.show_bit_width_assignments:
            for node, w in sorted(widths.items(), key=lambda kv: kv[0].uid):
                print(f"  %{node.uid} [{node.name}] : {w} bits")
        progress("parameter optimization")
        norm2 = graph.max_norm2()
        native_patterns, wide_inputs, wop_triples = tlu_pattern_split(graph)

        p_error = config.p_error
        n_pbs = None
        if config.global_p_error is not None:
            def pbs_of(n):
                size = max(int(np.prod(n.output.shape)), 1)
                if n.name in ("tlu", "univariate", "multivariate",
                              "dynamic_tlu"):
                    return size
                if n.name == "extract_bits":
                    pos = n.properties["kwargs"]["positions"]
                    return size * (max(int(q) for q in pos) + 1)
                return 0
            n_pbs = max(sum(pbs_of(n) for n in graph.graph.nodes), 1)
            # calibration search (reference V0Parameters.cpp:70-119
            # getSolutionWithGlobalPError): request the exact-product
            # allowed per-PBS error 1-(1-global)^(1/n) — strictly larger
            # than the old union-bound request global/n — and shrink only
            # if the solution's ACHIEVED global error (checked with the
            # exact product, not the union bound) misses the budget.
            # Large circuits with loose budgets get strictly cheaper
            # parameters (tests/test_global_p_error.py).  The MULTI
            # planner runs the same search over the plan's achieved
            # global error (multi.achieved_global_p_error).
            allowed = 1.0 - (1.0 - config.global_p_error) ** (1.0 / n_pbs)
            p_error = min(p_error or allowed, allowed)

        from concrete_tpu_torch.compilation.configuration import (
            MultiParameterStrategy, ParameterSelectionStrategy)
        plan = None
        if (config.forced_parameters is None and
                config.parameter_selection_strategy
                is ParameterSelectionStrategy.MULTI):
            # per-partition parameters (compilation/multi.py; reference
            # multi_parameters/partitionning.rs) — None when the circuit
            # has a single partition (mono IS the multi solution).
            # PRECISION cuts by encoding width; PRECISION_AND_NORM2
            # additionally splits same-width classes by norm2 bucket
            # (partition_cut.rs PrecisionAndNorm2).
            if (config.multi_parameter_strategy
                    is MultiParameterStrategy.PRECISION_AND_NORM2):
                from concrete_tpu_torch.compilation.widths import \
                    assign_norm2_partitions
                assign_norm2_partitions(graph,
                                        composable=config.composable)
            from concrete_tpu_torch.compilation.multi import (
                achieved_global_p_error, plan_partitions)
            multi_p_error = p_error
            # plan_partitions persists its merged grouping into node
            # properties; a calibration re-plan must start from the
            # original cut, so snapshot it
            part_snapshot = None
            if config.global_p_error is not None:
                part_snapshot = {
                    node: node.properties.get("partition")
                    for node in graph.graph.nodes
                    if node.output.is_encrypted}
            plan = plan_partitions(graph, p_error=multi_p_error,
                                   security_level=config.security_level,
                                   restriction=config.range_restriction)
            if config.global_p_error is not None and plan is not None:
                # the same exact-product calibration mono gets below:
                # shrink the per-PBS request until the plan's achieved
                # global error meets the budget (floor: the union bound,
                # always sufficient)
                target = config.global_p_error
                for _ in range(9):
                    ach_g = achieved_global_p_error(plan, graph)
                    if ach_g <= target or plan is None:
                        break
                    multi_p_error = max(
                        multi_p_error * max(target / ach_g, 1e-3),
                        target / n_pbs)
                    for node, pid in part_snapshot.items():
                        if pid is None:
                            node.properties.pop("partition", None)
                        else:
                            node.properties["partition"] = pid
                    plan = plan_partitions(
                        graph, p_error=multi_p_error,
                        security_level=config.security_level,
                        restriction=config.range_restriction)
                    if multi_p_error <= target / n_pbs:
                        break
                # plan may have flipped to None (mono now modeled
                # cheaper): the mono branch below calibrates itself

        wop_gadgets = config.forced_wop_parameters
        if plan is not None:
            from concrete_tpu_torch.compilation.widths import part_width
            params = plan.params[max(plan.params, key=part_width)]
        elif config.forced_parameters is not None:
            params = config.forced_parameters
        else:
            # one (precision, norm2) constraint per TLU/output — each PBS
            # runs at its own width (multi-precision mono); >8-bit TLUs add
            # noise-only input + WoP-output constraints (the CRT/WoP path)
            def _solve(pe):
                return optimize_v0_multi(
                    native_patterns, p_error=pe,
                    security_level=config.security_level,
                    noise_only=wide_inputs, wop_patterns=wop_triples,
                    restriction=config.range_restriction)
            params = _solve(p_error)
            if config.global_p_error is not None and native_patterns:
                # shrink the request until the solution's achieved global
                # error 1-(1-ach)^n_pbs (worst achieved per-PBS error
                # across patterns) meets the budget
                from concrete_tpu_torch.optimizer.v0 import achieved_p_error
                target = config.global_p_error
                for _ in range(9):
                    ach = achieved_p_error(params, native_patterns,
                                           wide_inputs)
                    if 1.0 - (1.0 - min(ach, 1.0)) ** n_pbs <= target:
                        break
                    p_error = max(p_error * (allowed / ach),
                                  target / n_pbs)
                    params = _solve(p_error)
                else:
                    p_error = target / n_pbs
                    params = _solve(p_error)
            if wop_triples and wop_gadgets is None:
                from concrete_tpu_torch.optimizer.v0 import \
                    choose_wop_gadgets
                nb_max = max(nb for nb, _, _ in wop_triples)
                out_cons = tuple(sorted({(w, n2)
                                         for _, w, n2 in wop_triples}))
                wp = choose_wop_gadgets(params, nb_max, out_cons,
                                        p_error=p_error)
                wop_gadgets = (wp.cbs_level, wp.cbs_base_log,
                               wp.pfks_level, wp.pfks_base_log)
        if wop_triples and plan is None and wop_gadgets is None:
            raise ValueError(
                "circuit contains >8-bit table lookups; forced_parameters "
                "compilation also needs forced_wop_parameters "
                "(cbs_level, cbs_base_log, pfks_level, pfks_base_log)")

        from concrete_tpu_torch.compilation.widths import partition_of
        specs = ClientSpecs(
            params=params, message_bits=p,
            inputs=[n.output for n in graph.ordered_inputs],
            outputs=[n.output for n in graph.ordered_outputs],
            input_widths=[encoding_width(n, p)
                          for n in graph.ordered_inputs],
            output_widths=[output_encoding_width(n, p)
                           for n in graph.ordered_outputs],
            input_partitions=[partition_of(n, p)
                              for n in graph.ordered_inputs]
            if plan is not None else None,
            output_partitions=[partition_of(n, p)
                               if n.output.is_encrypted
                               else output_encoding_width(n, p)
                               for n in graph.ordered_outputs]
            if plan is not None else None,
            wop_gadgets=wop_gadgets if wop_triples and plan is None else None,
            partitions=plan.params if plan is not None else None,
            partition_wop_gadgets=(plan.wop_gadgets or None)
            if plan is not None else None,
            conversions=(plan.fks or None) if plan is not None else None,
            partition_norm2=plan.norm2 if plan is not None else None)

        if config.verbose or config.show_graph:
            print(graph.format())
        if config.verbose or config.show_optimizer:
            print(f"optimizer: n={params.n_small} k={params.glwe_dimension} "
                  f"N={params.polynomial_size} "
                  f"br=({params.pbs_level},{params.pbs_base_log}) "
                  f"ks=({params.ks_level},{params.ks_base_log}) "
                  f"p_error<={p_error:.2e}"
                  + (f" wop_gadgets={wop_gadgets}" if wop_gadgets else ""))
        progress("lowering")
        circuit = Circuit(graph, specs, configuration=config, device=device)
        if config.show_mlir:
            # the IR analog of the reference's MLIR dump: the per-node
            # lowering plan the executor will run
            print(circuit.server.lowering_text())
        if config.verbose or config.show_statistics:
            print(f"precision: {p} bits, norm2: {norm2:g}, "
                  f"params: n={params.n_small} k={params.glwe_dimension} "
                  f"N={params.polynomial_size}, "
                  f"pbs_count: {circuit.programmable_bootstrap_count}")
        if artifacts is not None:
            artifacts.add_graph(graph.name, graph)
            artifacts.add_bounds(graph)
            artifacts.add_parameters(params)
            artifacts.add_statistics(circuit)
            artifacts.export()
        return circuit

    # tracing without compiling (reference Compiler.trace)
    def trace(self, inputset):
        inputset = list(inputset)
        graph = Tracer.trace(self.function,
                             self.parameter_encryption_statuses,
                             sample=inputset[0], name=self.function.__name__)
        graph.measure_bounds(inputset)
        graph.update_dtypes_from_bounds()
        return graph


def compiler(parameter_encryption_statuses: dict[str, str]):
    """The @fhe.compiler({"x": "encrypted"}) decorator (reference
    decorators.py)."""

    def decoration(function: Callable):
        return Compiler(function, parameter_encryption_statuses)

    return decoration


def circuit(parameter_encryption_statuses: dict[str, str],
            configuration: Optional[Configuration] = None, **kwargs):
    """Direct circuits: ranges come from type annotations, no inputset.

    Reference: @fhe.circuit with tracing/typing.py annotations.

        @fhe.circuit({"x": "encrypted"})
        def f(x: fhe.uint3):
            return x + 1
    """
    import inspect

    from concrete_tpu_torch.tracing.typing import annotation_inputset

    def decoration(function: Callable) -> Circuit:
        sig = inspect.signature(function)
        anns = []
        for pname, param in sig.parameters.items():
            if param.annotation is inspect.Parameter.empty:
                raise ValueError(
                    f"direct circuits need a type annotation for '{pname}' "
                    "(e.g. fhe.uint3)")
            anns.append(param.annotation)
        inputset = annotation_inputset(anns)
        comp = Compiler(function, parameter_encryption_statuses)
        return comp.compile(inputset, configuration, **kwargs)

    return decoration
