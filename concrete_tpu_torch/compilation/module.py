"""Multi-function modules with composition.

Reference: frontends/concrete-python/concrete/fhe/compilation/module.py
(FheModule/FheFunction, ExecutionRt) and module_compiler.py (ModuleCompiler
with @fhe.function methods).  All functions of a module share one keyset, so
any composable function's encrypted output can feed any composable
function's encrypted input without decryption.

Counterpart of ``concrete_tpu/compilation/module.py``: the same trace, the
same composition policy (``compilation/composition.py``), the same pooled
parameter search and WoP gadgets, the same per-position encoding widths and
the same messages, so one module compiles to the JAX package's graphs and
``ClientSpecs``.  The functions run on ``device`` (None means CUDA).  They
share one ``Keys``, and so one packed keyset per (message bits, norm2):
``Keys.evaluation_for`` packs and caches, no function packs on its own.
``FheFunction.run`` returns ``Server.run``'s host u64 arrays; a composed
call uploads them again.  ``simulate`` runs the host simulation
(``simulation/``); ``run_async`` runs on the dataflow scheduler and takes
Futures of other functions' calls as arguments.
"""

from __future__ import annotations

from typing import Callable, Optional

from concrete_tpu_torch.compilation.client import Client
from concrete_tpu_torch.compilation.configuration import Configuration
from concrete_tpu_torch.compilation.keys import Keys
from concrete_tpu_torch.compilation.server import Server
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.compilation.transforms import run_default_transforms
from concrete_tpu_torch.tracing import Tracer
from concrete_tpu_torch.utils.device import resolve_device


class FunctionDef:
    """One function of a module (reference module_compiler.py:34)."""

    def __init__(self, function: Callable, statuses: dict[str, str]):
        self.function = function
        self.statuses = statuses
        self.graph = None

    def trace_and_measure(self, inputset):
        inputset = list(inputset)
        if not inputset:
            raise ValueError(
                f"inputset for module function "
                f"'{self.function.__name__}' must not be empty")
        graph = Tracer.trace(self.function, self.statuses,
                             sample=inputset[0],
                             name=self.function.__name__)
        run_default_transforms(graph)
        graph.measure_bounds(inputset)
        graph.update_dtypes_from_bounds()
        self.graph = graph
        return graph


def function(statuses: dict[str, str]):
    """Marks a module method as an FHE function (reference @fhe.function)."""

    def decorator(fn):
        fn._fhe_function = FunctionDef(fn, statuses)
        return fn

    return decorator


class FheFunction:
    """A compiled module function: encrypt, run and decrypt through the
    module's shared keys, run on the module's device."""

    def __init__(self, name: str, graph, specs: ClientSpecs, client: Client,
                 configuration: Optional[Configuration] = None,
                 device=None):
        self.name = name
        self.graph = graph
        self.client_specs = specs
        self.client = client
        self.configuration = configuration
        self.server = Server(graph, specs, device=device)
        self.device = self.server.device

    def encrypt(self, *args):
        """The client's encryption; seeded (``SeededLweCiphertext``) under
        ``Configuration.compress_input_ciphertexts``, as
        ``Circuit.encrypt``."""
        compress = bool(self.configuration is not None and
                        self.configuration.compress_input_ciphertexts)
        return self.client.encrypt(*args, compress=compress)

    def _evaluation_keys(self):
        """The module keyset packed for this function's norm2 (cached in
        ``Keys`` per message bits, norm2 and device, so functions of equal
        norm2 share one pack), with the PFPKSK where the module has WoP
        lookups.  A WoP module packs the untruncated BSK, as
        ``Circuit._evaluation_keys`` does."""
        if not hasattr(self, "_norm2"):
            self._norm2 = self.graph.max_norm2()
        wp = self.client_specs.wop_params()
        eval_keys = self.client.keys.evaluation_for(
            None if wp is not None else self.client_specs.message_bits,
            norm2=self._norm2, device=self.device)
        if wp is not None:
            eval_keys = eval_keys + (self.client.keys.wop_evaluation(
                wp, device=self.device),)
        return eval_keys

    def run(self, *args):
        if self.client_specs.wop_params() is not None:
            # fail fast, before the PFPKSK is generated or packed
            self.server.check_wop_memory()
        self.client.keygen()
        outs = self.server.run(*args, evaluation_keys=self._evaluation_keys())
        return outs if len(outs) != 1 else outs[0]

    def decrypt(self, *results):
        return self.client.decrypt(*results)

    def encrypt_run_decrypt(self, *args):
        enc = self.encrypt(*args)
        if len(self.client_specs.inputs) == 1:
            enc = (enc,)
        res = self.run(*enc)
        if len(self.client_specs.outputs) == 1:
            return self.decrypt(res)
        return self.decrypt(*res)

    def simulate(self, *args):
        """Noise-accurate plaintext simulation of this function, on the
        host."""
        from concrete_tpu_torch.simulation import simulate_graph
        return simulate_graph(self.graph, self.client_specs, *args)

    def run_async(self, *args):
        """Run on the dataflow scheduler; args may be Futures of other
        functions' run_async results (module composition as a task graph
        — the RT/DFR analog)."""
        from concrete_tpu_torch.compilation.scheduler import \
            default_scheduler
        return default_scheduler().submit(self.run, *args)

    @property
    def _statistic_records(self):
        from concrete_tpu_torch.compilation import statistics as st
        if not hasattr(self, "_stats_cache"):
            self._stats_cache = st.collect(
                self.graph, self.server._executor,
                self.client_specs.message_bits)
        return self._stats_cache

    @property
    def statistics(self) -> dict:
        """Primitive-op counts for this function (reference module
        function feedback; same grid as Circuit.statistics)."""
        from concrete_tpu_torch.compilation import statistics as st
        recs = self._statistic_records
        out = {}
        for kind in st.KINDS:
            out[f"{kind}_count"] = st.total(recs, kind)
            out[f"{kind}_count_per_parameter"] = st.per_parameter(recs, kind)
            out[f"{kind}_count_per_tag"] = st.per_tag(recs, kind)
        return out

    @property
    def programmable_bootstrap_count(self) -> int:
        from concrete_tpu_torch.compilation import statistics as st
        return st.total(self._statistic_records, st.PBS)


class FheModule:
    """A set of compiled functions sharing one keyset (composable)."""

    def __init__(self, functions: dict[str, FheFunction], keys: Keys,
                 device=None):
        self._functions = functions
        self.keys = keys
        self.device = device      # where keygen computes the key bodies

    def __getattr__(self, name):
        fns = object.__getattribute__(self, "_functions")
        if name in fns:
            return fns[name]
        raise AttributeError(name)

    @property
    def function_names(self):
        return list(self._functions)

    def keygen(self, force: bool = False, seed: Optional[int] = None):
        if force or not self.keys.are_generated:
            self.keys.generate(seed, device=self.device)


class ModuleCompiler:
    def __init__(self, cls):
        self.cls = cls
        self.functions: dict[str, FunctionDef] = {}
        for attr in dir(cls):
            fn = getattr(cls, attr)
            fdef = getattr(fn, "_fhe_function", None)
            if fdef is not None:
                self.functions[attr] = fdef

    def compile(self, inputsets: dict[str, list],
                configuration: Optional[Configuration] = None,
                device=None, **kwargs) -> FheModule:
        """Compile every function with the module's shared parameters;
        the functions run on `device` (None means CUDA).  The insecure key
        cache of the configuration, if set, holds the module's keyset."""
        config = configuration or Configuration()
        if kwargs:
            config = config.fork(**kwargs)
        device = resolve_device(device)
        graphs = {}
        p = 1
        norm2 = 1
        for name, fdef in self.functions.items():
            if name not in inputsets:
                raise ValueError(f"no inputset for module function '{name}'")
            g = fdef.trace_and_measure(inputsets[name])
            graphs[name] = g
            p = max(p, g.max_bit_width)
            norm2 = max(norm2, g.max_norm2())
        # the composition policy (reference composition.py; class attribute
        # `composition`, default AllComposable) decides which functions need
        # the shared module-wide encoding: composable functions pin every
        # value to the module width, the rest keep per-value widths
        from concrete_tpu_torch.compilation.composition import (
            AllComposable, CompositionPolicy)
        from concrete_tpu_torch.compilation.widths import (
            assign_encoding_widths, encoding_width, output_encoding_width,
            tlu_pattern_split)
        policy = getattr(self.cls, "composition", None)
        if policy is None:
            policy = AllComposable()
        if not isinstance(policy, CompositionPolicy):
            raise TypeError("module `composition` must be a "
                            "CompositionPolicy (AllComposable / "
                            "NotComposable / Wired)")
        unified = policy.unified_functions(graphs)
        for name, g in graphs.items():
            if name in unified:
                for node in g.graph.nodes:
                    if node.output.is_encrypted:
                        node.properties["encoding_width"] = p
            else:
                assign_encoding_widths(g)
        # composition soundness: a composable output re-enters as an input,
        # and the atomic-pattern model assumes inputs start at one fresh
        # blind-rotate noise — sound for arbitrarily long chains only when
        # the output carries NO leveled amplification since its last PBS
        # (reference composition rules require refreshed outputs)
        for name in sorted(unified):
            g = graphs[name]
            manp, _ = g.manp_map()
            for pos, out in enumerate(g.ordered_outputs):
                if out.output.is_encrypted and manp.get(out, 1) > 1:
                    raise ValueError(
                        f"module function '{name}' output {pos} carries "
                        f"leveled amplification (norm2^2 = "
                        f"{manp.get(out)}) since its last bootstrap: "
                        "composing it would compound noise beyond the "
                        "parameter budget.  Refresh it (fhe.refresh / a "
                        "final TLU) or mark the module NotComposable")
        # pooled per-TLU constraints across every function (the module
        # shares one keyset): each PBS runs at its own width; >8-bit TLUs
        # add WoP constraints exactly as the single-function Compiler does
        native_patterns: list = []
        wide_inputs: list = []
        wop_triples: list = []
        for g in graphs.values():
            nat, wide, wop = tlu_pattern_split(g)
            native_patterns.extend(nat)
            wide_inputs.extend(wide)
            wop_triples.extend(wop)
        p_error = config.p_error or 6.3e-5
        wop_gadgets = config.forced_wop_parameters
        if config.forced_parameters is not None:
            params = config.forced_parameters
        else:
            from concrete_tpu_torch.optimizer.v0 import (choose_wop_gadgets,
                                                         optimize_v0_multi)
            params = optimize_v0_multi(
                tuple(native_patterns) or ((p, norm2),), p_error=p_error,
                security_level=config.security_level,
                noise_only=tuple(wide_inputs),
                wop_patterns=tuple(wop_triples))
            if wop_triples and wop_gadgets is None:
                nb_max = max(nb for nb, _, _ in wop_triples)
                out_cons = tuple(sorted({(w, n2)
                                         for _, w, n2 in wop_triples}))
                wp = choose_wop_gadgets(params, nb_max, out_cons,
                                        p_error=p_error)
                wop_gadgets = (wp.cbs_level, wp.cbs_base_log,
                               wp.pfks_level, wp.pfks_base_log)
        if wop_triples and wop_gadgets is None:
            raise ValueError(
                "module contains >8-bit table lookups; forced_parameters "
                "compilation also needs forced_wop_parameters "
                "(cbs_level, cbs_base_log, pfks_level, pfks_base_log)")
        cache = config.insecure_key_cache_location \
            if config.use_insecure_key_cache else None
        keys = Keys(params, cache_directory=cache)
        functions = {}
        for name, g in graphs.items():
            specs = ClientSpecs(
                params=params, message_bits=p,
                inputs=[n.output for n in g.ordered_inputs],
                outputs=[n.output for n in g.ordered_outputs],
                # per-position encoding widths: unified functions use the
                # module width, NotComposable/unwired ones their own
                # (without these the client would encode at message_bits
                # while the executor uses per-node widths -> garbage)
                input_widths=[encoding_width(n, p)
                              for n in g.ordered_inputs],
                output_widths=[output_encoding_width(n, p)
                               for n in g.ordered_outputs],
                wop_gadgets=wop_gadgets if wop_triples else None)
            client = Client(specs, keys, device=device)
            functions[name] = FheFunction(name, g, specs, client,
                                          configuration=config,
                                          device=device)
        return FheModule(functions, keys, device=device)


def module():
    """The @fhe.module() class decorator (reference decorators.py)."""

    def decorator(cls):
        return ModuleCompiler(cls)

    return decorator
