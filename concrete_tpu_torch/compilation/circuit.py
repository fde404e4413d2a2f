"""Circuit: the user-facing compiled object.

Counterpart of ``concrete_tpu/compilation/circuit.py`` (itself after the
reference's frontends/concrete-python/concrete/fhe/compilation/
circuit.py:25-576): keygen / encrypt / run / decrypt and the statistics
properties.  Key generation, encryption and decryption run on the host;
``run`` runs on the circuit's torch device, which is the card unless the
caller asks for the CPU (``device=None`` means CUDA and raises without
one, ``utils/device.resolve_device``).

The circuit packs its keyset for the device once and reuses the packed
keys on every run (``Keys.evaluation_for`` caches them until the next
keygen).  A multi-partition circuit gets a ``MultiKeys``: full keysets for
the partitions that run a PBS, secret-only ones for the others, and the
conversion keys of its frontiers.  The configuration's insecure key
cache holds the keyset (``Keys``/``MultiKeys``), and
``compress_input_ciphertexts`` makes ``encrypt`` seeded.

``simulate`` runs the noise-accurate plaintext simulation on the host
(``simulation/``, no keys); ``run_async`` hands the call to the dataflow
scheduler (``compilation/scheduler.py``) and returns a Future, as ``run``
does under ``Configuration.auto_schedule_run``.
"""

from __future__ import annotations

from typing import Optional

from concrete_tpu_torch.compilation.client import Client
from concrete_tpu_torch.compilation.keys import Keys, MultiKeys
from concrete_tpu_torch.compilation.server import Server
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.representation import Graph
from concrete_tpu_torch.utils import telemetry as tm
from concrete_tpu_torch.utils.device import resolve_device


class Circuit:
    def __init__(self, graph: Graph, specs: ClientSpecs,
                 configuration=None, device=None):
        self.graph = graph
        self.client_specs = specs
        self.configuration = configuration
        self.device = resolve_device(device)
        cache = None
        if configuration is not None and configuration.use_insecure_key_cache:
            cache = configuration.insecure_key_cache_location
        if specs.is_multi:
            keys = MultiKeys(specs.partitions, specs.conversions or {},
                             cache_directory=cache,
                             pbs_widths=self._pbs_widths())
        else:
            keys = Keys(specs.params, cache_directory=cache)
        self.client = Client(specs, keys, device=self.device)
        # the server refuses an unported node kind here, before any key is
        # generated
        self.server = Server(graph, specs, device=self.device)

    def _pbs_widths(self) -> frozenset:
        """Partition ids that run a PBS (lookup input partitions): the
        other partitions only encrypt and decrypt and get secret-only
        keysets (a pure output partition can sit at N=2^14+, where a BSK
        is GBs of dead weight)."""
        from concrete_tpu_torch.compilation.widths import (
            TLU_OPS, tlu_input_partition)
        default = self.client_specs.message_bits
        widths = set()
        for node in self.graph.topological_order():
            if node.name in TLU_OPS and any(
                    p.output.is_encrypted
                    for p in self.graph.ordered_preds_of(node)):
                widths.add(tlu_input_partition(self.graph, node, default))
        return frozenset(widths)

    # -- key management ----------------------------------------------------

    @property
    def keys(self):
        """The client's ``Keys``, or ``MultiKeys`` for a multi-partition
        circuit."""
        return self.client.keys

    def keygen(self, force: bool = False, seed: Optional[int] = None) -> None:
        self.client.keygen(force=force, seed=seed)

    # -- the full pipeline -------------------------------------------------

    def encrypt(self, *args):
        """The client's encryption; seeded (``SeededLweCiphertext``) under
        ``Configuration.compress_input_ciphertexts``."""
        compress = bool(self.configuration is not None and
                        self.configuration.compress_input_ciphertexts)
        return self.client.encrypt(*args, compress=compress)

    def _evaluation_keys(self):
        """The keyset packed for this circuit's device, BSK form and
        truncation, with the packed PFPKSK for a WoP circuit (as the JAX
        package's ``_evaluation_keys``).  A WoP circuit packs the
        untruncated BSK: the truncation rule is sized for one
        message_bits-wide PBS, and the circuit bootstrap consumes the blind
        rotate's noise at scale 2^(64 - cbs_level cbs_base_log).

        Multi-partition: (ksk, bsk, pfpksk or None, fks), dicts keyed by
        partition id (each partition's pack at its own norm2, a WoP
        partition's untruncated) and by frontier (the conversion keys)."""
        if self.client_specs.is_multi:
            return self._multi_evaluation_keys()
        if not hasattr(self, "_norm2"):
            self._norm2 = self.graph.max_norm2()
        wp = self.client_specs.wop_params()
        eval_keys = self.keys.evaluation_for(
            None if wp is not None else self.client_specs.message_bits,
            norm2=self._norm2, device=self.device)
        if wp is not None:
            eval_keys = eval_keys + (self.keys.wop_evaluation(
                wp, device=self.device),)
        return eval_keys

    def _multi_evaluation_keys(self):
        specs, mk = self.client_specs, self.keys
        norm2 = specs.partition_norm2 or {}
        wop_widths = specs.partition_wop_gadgets or {}
        pbs_widths = self._pbs_widths()
        ksk, bsk = {}, {}
        for w in specs.partitions:
            if w not in pbs_widths:
                continue    # a secret-only partition: no PBS ever runs
            if w in wop_widths:
                k, b = mk.keys_for(w).evaluation_for(None,
                                                     device=self.device)
            else:
                k, b = mk.evaluation_for_width(w, norm2=norm2.get(w, 1),
                                               device=self.device)
            ksk[w], bsk[w] = k, b
        pfpksk = {w: mk.wop_evaluation_for(w, specs.wop_params(w),
                                           device=self.device)
                  for w in wop_widths}
        fks = {key: mk.conversion_key(*key, device=self.device)
               for key in (specs.conversions or {})}
        return ksk, bsk, pfpksk or None, fks

    def run(self, *args):
        if (self.configuration is not None
                and self.configuration.auto_schedule_run):
            # reference ExecutionRt auto_schedule_run: hand the call to the
            # background pool and return a Future
            return self.run_async(*args)
        return self._run_sync(*args)

    def _run_sync(self, *args):
        with tm.request("circuit.run") if tm.on else tm.OFF:
            if self.client_specs.wop_params() is not None:
                # fail fast, before the PFPKSK is generated or packed
                self.server.check_wop_memory()
            with tm.span("circuit.keys") if tm.on else tm.OFF:
                self.keygen()
                evaluation_keys = self._evaluation_keys()
            return_tuple = self.server.run(*args,
                                           evaluation_keys=evaluation_keys)
        return return_tuple if len(return_tuple) != 1 else return_tuple[0]

    def decrypt(self, *results):
        return self.client.decrypt(*results)

    def encrypt_run_decrypt(self, *args):
        """The one-call convenience oracle (reference circuit.py).

        Under Configuration.simulate_encrypt_run_decrypt, or a
        simulation-only configuration (fhe_simulation without
        fhe_execution), the call runs the noise-accurate simulator instead
        (reference configuration semantics)."""
        cfg = self.configuration
        if cfg is not None and (cfg.simulate_encrypt_run_decrypt
                                or (cfg.fhe_simulation
                                    and not cfg.fhe_execution)):
            return self.simulate(*args)
        enc = self.encrypt(*args)
        if len(self.client_specs.inputs) == 1:
            enc = (enc,)
        res = self._run_sync(*enc)
        if len(self.client_specs.outputs) == 1:
            return self.decrypt(res)
        return self.decrypt(*res)

    def simulate(self, *args):
        """Noise-accurate plaintext simulation on the host (no keys, no
        device)."""
        from concrete_tpu_torch.simulation import simulate_graph
        detect = bool(self.configuration is not None and
                      self.configuration.detect_overflow_in_simulation)
        return simulate_graph(self.graph, self.client_specs, *args,
                              detect_overflow=detect)

    def run_async(self, *args):
        """Run on the dataflow scheduler; returns a Future.  Arguments may
        themselves be Futures of earlier run_async calls — composition
        chains execute as a dependency graph without blocking the caller
        (the RT-dialect / DFR analog, compilation/scheduler.py).  The
        call's exception, if any, comes out of the Future's ``result()``.

        Reference: ExecutionRt's auto_schedule_run thread pool
        (compilation/module.py:32-66) + the RT dataflow runtime.
        """
        from concrete_tpu_torch.compilation.scheduler import \
            default_scheduler
        return default_scheduler().submit(self._run_sync, *args)

    # -- statistics (reference circuit.py:236-533) -------------------------

    @property
    def complexity(self) -> float:
        return self.server.complexity

    @property
    def _statistic_records(self):
        """Primitive-op records from the ExtractStatistics analog
        (compilation/statistics.py); cached per circuit."""
        from concrete_tpu_torch.compilation import statistics as st
        if not hasattr(self, "_stats_cache"):
            self._stats_cache = st.collect(
                self.graph, self.server._executor,
                self.client_specs.message_bits)
        return self._stats_cache

    @property
    def statistics(self) -> dict:
        """All primitive-op counts in one dict (reference circuit.py:525):
        {kind: {"total", "per_parameter", "per_tag",
        "per_tag_per_parameter"}} plus sizes and error rates."""
        from concrete_tpu_torch.compilation import statistics as st
        recs = self._statistic_records
        out = {}
        for kind in st.KINDS:
            out[f"{kind}_count"] = st.total(recs, kind)
            out[f"{kind}_count_per_parameter"] = st.per_parameter(recs, kind)
            out[f"{kind}_count_per_tag"] = st.per_tag(recs, kind)
            out[f"{kind}_count_per_tag_per_parameter"] = \
                st.per_tag_per_parameter(recs, kind)
        out.update(
            size_of_secret_keys=self.size_of_secret_keys,
            size_of_bootstrap_keys=self.size_of_bootstrap_keys,
            size_of_keyswitch_keys=self.size_of_keyswitch_keys,
            size_of_inputs=self.size_of_inputs,
            size_of_outputs=self.size_of_outputs,
            p_error=self.p_error,
            global_p_error=self.global_p_error,
            complexity=self.complexity,
        )
        return out

    @property
    def size_of_secret_keys(self) -> int:
        p = self.client_specs.params
        return (p.n_small + p.n_big) * 8

    @property
    def size_of_bootstrap_keys(self) -> int:
        p = self.client_specs.params
        return (p.n_small * p.pbs_level * (p.glwe_dimension + 1) ** 2
                * p.polynomial_size * 8)

    @property
    def size_of_keyswitch_keys(self) -> int:
        p = self.client_specs.params
        return p.n_big * p.ks_level * (p.n_small + 1) * 8

    @property
    def size_of_inputs(self) -> int:
        p = self.client_specs.params
        return sum(v.size * (p.n_big + 1) * 8
                   for v in self.client_specs.inputs if v.is_encrypted)

    @property
    def size_of_outputs(self) -> int:
        p = self.client_specs.params
        return sum(v.size * (p.n_big + 1) * 8
                   for v in self.client_specs.outputs if v.is_encrypted)

    @property
    def programmable_bootstrap_count_per_bit_width(self) -> dict:
        """PBS counts keyed by each bootstrap's *input* encoding width
        (the dict sums to programmable_bootstrap_count)."""
        from concrete_tpu_torch.compilation import statistics as st
        out: dict = {}
        for r in self._statistic_records:
            if r.kind == st.PBS:
                out[r.parameter] = out.get(r.parameter, 0) + r.count
        return out

    @property
    def p_error(self) -> float:
        """Failure probability at the circuit's worst decision point,
        evaluated on the graph's actual per-node noise coefficients
        (Graph.variance_pairs): fresh-input noise is charged at the
        encryption variance, PBS-sourced noise at the blind-rotate
        variance — the same constraints the optimizer solved."""
        from concrete_tpu_torch import params as pp
        from concrete_tpu_torch.compilation.widths import tlu_pattern_split
        specs = self.client_specs
        if specs.is_multi and specs.partition_norm2:
            return max(
                specs.partitions[w].p_error(
                    min(w, 8), norm2=specs.partition_norm2.get(w, 1))
                for w in specs.partitions)
        params = specs.params
        native, wide_in, wop = tlu_pattern_split(self.graph)
        v_fresh = params.glwe_std ** 2
        v_br = pp.variance_blind_rotate(
            params.n_small, params.glwe_dimension, params.polynomial_size,
            params.pbs_base_log, params.pbs_level, params.glwe_std ** 2)
        v_ks = pp.variance_keyswitch(params.n_big, params.ks_base_log,
                                     params.ks_level, params.lwe_std ** 2)
        v_ms = pp.variance_modulus_switch(params.n_small,
                                          params.log2_polynomial_size)
        v_out_wop = None
        if wop and specs.wop_gadgets:
            cbs_l, cbs_b, pfks_l, pfks_b = specs.wop_gadgets
            nb_max = max(nb for nb, _, _ in wop)
            v_out_wop = pp.wop_output_variance(params, nb_max, cbs_b,
                                               cbs_l, pfks_b, pfks_l)
        worst = 0.0
        for p, i_sq, l_sq in native:
            var = i_sq * v_fresh + l_sq * v_br + v_ks + v_ms
            worst = max(worst, pp.p_error_from_variance(var, int(p)))
        for p, i_sq, l_sq in wide_in:
            # bit-extraction decision: KS+MS noise enters after the shift
            # (optimizer noise_only weighting)
            var = (i_sq * v_fresh + l_sq * v_br
                   + (v_ks + v_ms) * 4.0 ** -int(p))
            worst = max(worst, pp.p_error_from_variance(var, int(p)))
        if v_out_wop is not None:
            for _, w, n2o in wop:
                var = v_out_wop * float(n2o) ** 2 + v_ks + v_ms
                worst = max(worst, pp.p_error_from_variance(var, int(w)))
        return worst

    @property
    def global_p_error(self) -> float:
        n = self.programmable_bootstrap_count
        if n == 0:
            return 0.0   # a PBS-free (levelled) circuit cannot misdecide
        pe = self.p_error
        return 1.0 - (1.0 - pe) ** n

    def cleanup(self) -> None:
        """Release execution resources (reference circuit.py:226)."""

    def __str__(self) -> str:
        return self.graph.format()


def _install_statistic_properties() -> None:
    """Attach the reference's full `*_count*` property grid (circuit.py:
    302-533): for each primitive-op kind, `<kind>_count`,
    `<kind>_count_per_parameter` (parameter = partition encoding width),
    `<kind>_count_per_tag`, and `<kind>_count_per_tag_per_parameter`."""
    from concrete_tpu_torch.compilation import statistics as st

    def make(kind, agg, doc):
        def get(self):
            return agg(self._statistic_records, kind)
        get.__doc__ = doc
        return property(get)

    for kind in st.KINDS:
        for suffix, agg in (("", st.total),
                            ("_per_parameter", st.per_parameter),
                            ("_per_tag", st.per_tag),
                            ("_per_tag_per_parameter",
                             st.per_tag_per_parameter)):
            name = f"{kind}_count{suffix}"
            if name in Circuit.__dict__:
                continue
            setattr(Circuit, name, make(
                kind, agg,
                f"Number of {kind.replace('_', ' ')} operations per run"
                f"{suffix.replace('_', ' ')} (ExtractStatistics analog)."))


_install_statistic_properties()
