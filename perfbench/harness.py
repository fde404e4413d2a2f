"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix or metric is
found by its name:

- ``configs/<config>.json`` states the configuration (the keyset it is
  compiled to, the output's encoding, the declared error probability) and
  ``configs/<config>.py`` builds its circuit through the program's public
  API (``build``), draws one request's clear inputs (``draw``) and lists
  the blind rotates one request runs (``blind_rotates``); it may define
  ``output_check(keyset, shape)``, what a well-formed output is (default:
  ``output_check`` here, one u64 array of ciphertexts);
- ``reference/<config>.py`` holds its plain clear function (``clear``); it
  may define ``secret_key(seed, keyset)`` and ``read_output(secret, out,
  output)``, the key derived again from the seed and the decrypted,
  decoded output (default: ``reference/keys.py``'s, one GLWE key);
- ``traffic/<mix>.json`` gives the loop's parameters: the request shape,
  the pool of distinct encrypted requests, the warm-up, the traced
  stretch, and for several cards how the batch is split;
- ``metrics/<metric>.py`` reads one metric from the run's records
  (``read``); a name with a suffix after a dot (``name.tput``) is read by
  ``metrics/<name>.py``.

A run: set-up (compile, keygen, the first key pack, the request pool,
warm-up), then a closed loop with one client for the window, then the
judgement of every output of the window against the reference, then one
JSON line.  Several cards: ``ranks.py``.  The control of that judgement
(``control_key``) is the same run with the key one precision step below
the program's truncation rule.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "concrete_tpu_torch"
#: top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "concrete_tpu")
#: an honest run's wrong decryptions exceed the declared rate's limit
#: with at most this probability
FALSE_ALARM = 1e-9
BR_KERNELS = os.path.join(HERE, "blind_rotate_kernels.txt")


class Cell:
    """One workload of BENCHMARK.json with its files loaded."""

    def __init__(self, spec: dict, name: str):
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                           f"{sorted(work)}")
        self.workload = work[name]
        self.name = name
        entry = {c["name"]: c for c in spec["configs"]}[
            self.workload["config"]]
        with open(os.path.join(ROOT, entry["file"])) as f:
            self.config = json.load(f)
        cfg = entry["name"]
        self.build = load_module(os.path.join(HERE, "configs", cfg + ".py"))
        self.reference = load_module(
            os.path.join(HERE, "reference", cfg + ".py"))
        with open(os.path.join(HERE, "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m["name"] for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m["name"] for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]
        self.shape = tuple(self.traffic["shape"])
        self.spec = spec

    def reader(self, metric: str):
        return load_module(os.path.join(
            HERE, "metrics", metric.split(".")[0] + ".py")).read

    def output_check(self, keyset: dict, shape):
        return getattr(self.build, "output_check", output_check)(keyset,
                                                                 shape)


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str):
    name = "perfbench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def br_kernel_names() -> list:
    with open(BR_KERNELS) as f:
        return [ln.split("#")[0].strip() for ln in f
                if ln.split("#")[0].strip()]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def poisson_limit(mean: float, tail: float = FALSE_ALARM) -> int:
    """The least k with P(X > k) <= tail for X ~ Poisson(mean)."""
    if mean <= 0:
        return 0
    k, pmf = 0, math.exp(-mean)
    cdf = pmf
    while 1.0 - cdf > tail:
        k += 1
        pmf *= mean / k
        cdf += pmf
    return k


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------

def synchronize(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def configuration(overrides: dict):
    """The port's default ``Configuration()``, or one with forced
    parameters (the CPU rehearsals' insecure sets)."""
    import concrete_tpu_torch as fhe
    if overrides.get("params") is not None:
        return fhe.Configuration(forced_parameters=overrides["params"])
    return fhe.Configuration()


def keyset_of(params) -> dict:
    return {k: int(getattr(params, k)) for k in (
        "n_small", "glwe_dimension", "polynomial_size", "pbs_level",
        "pbs_base_log", "ks_level", "ks_base_log")}


def start_program(device, spans: dict) -> None:
    """Import the program and make the device's context, each timed, so
    that neither lands in the compile or keygen span."""
    import torch
    t0 = time.perf_counter()
    import concrete_tpu_torch  # noqa: F401
    spans["import_s"] = time.perf_counter() - t0
    device = torch.device(device)
    if device.type == "cuda":
        t0 = time.perf_counter()
        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
        spans["cuda_init_s"] = time.perf_counter() - t0


def compile_circuit(cell: Cell, device, spans: dict, shape=None,
                    overrides: dict = None):
    t0 = time.perf_counter()
    circuit = cell.build.build(cell.shape if shape is None else shape,
                               configuration(overrides or {}),
                               device=device)
    spans["compile_s"] = time.perf_counter() - t0
    return circuit


def make_keys(circuit, seed: int, spans: dict, detail: dict):
    """Keygen from the seed, then the first pack for the circuit's
    device: the pack every request of the window runs on."""
    t0 = time.perf_counter()
    circuit.keygen(force=True, seed=seed)
    synchronize(circuit.device)
    spans["keygen_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = circuit._evaluation_keys()
    synchronize(circuit.device)
    spans["pack_s"] = time.perf_counter() - t0
    detail["keys_setup_seconds"] = dict(circuit.keys.setup_seconds)
    return packed


def _crt_bits(primes) -> int:
    return math.prod(primes).bit_length() - 1


def control_key(circuit, packed_bsk):
    """The control's bootstrapping key: the circuit's BSK packed one
    precision step below what the program's truncation rule proves
    negligible, which breaks the configuration's declared error
    probability.  A banded key (int8 limb planes) drops one more 8-bit
    limb plane (``core.kernels.pack_bsk``'s ``truncate_limbs``); a fused
    CRT-NTT key runs on one CRT prime fewer, with the truncation that the
    fewer primes' range forces (``ops.fused_ntt.pack_bsk_fused``).
    Returns the key and what was changed."""
    from concrete_tpu_torch.core import kernels as kn
    from concrete_tpu_torch.ops import fused_ntt
    params = circuit.client_specs.params
    bsk_u64 = circuit.keys.server.bsk
    if isinstance(packed_bsk, fused_ntt.FusedBSK):
        primes = tuple(packed_bsk.primes)
        fewer = primes[:-1]
        trunc = packed_bsk.trunc_bits + _crt_bits(primes) - _crt_bits(fewer)
        return fused_ntt.pack_bsk_fused(bsk_u64, params, primes=fewer,
                                        trunc_bits=trunc,
                                        device=circuit.device), {
            "primes": len(fewer), "trunc_bits": trunc}
    t = packed_bsk.truncate_limbs + 1
    return kn.pack_bsk(bsk_u64, params, truncate_limbs=t,
                       device=circuit.device), {"truncate_limbs": t}


def draw_pool(cell: Cell, seed: int, size: int, shape=None) -> list:
    """The pool's clear requests, from the seed alone."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    shape = cell.shape if shape is None else shape
    return [tuple(cell.build.draw(rng, shape)) for _ in range(size)]


def encrypt_pool(circuit, clear: list) -> list:
    out = []
    for args in clear:
        enc = circuit.encrypt(*args)
        out.append(enc if isinstance(enc, tuple) else (enc,))
    return out


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Window:
    """The closed loop with one client: the next request starts when the
    previous one has returned its host arrays.  `serve(i)` runs request i
    of the pool and returns its output; `decide(go, traced)` lets several
    ranks follow the first one's choices."""

    def __init__(self, serve, check, seconds: float, trace_plan=None,
                 cuda: bool = False, decide=None):
        self.serve, self.check, self.seconds = serve, check, seconds
        self.trace_plan, self.cuda, self.decide = trace_plan, cuda, decide
        self.latencies, self.outputs, self.indices = [], [], []
        self.attempted = self.failed = 0
        self.errors = []
        self.raw = None
        self.window_s = 0.0

    def run(self) -> None:
        """Drive the window; with a trace plan (after, seconds, least), one
        stretch of it under the profiler: from `after` of the window on,
        for `seconds` and at least `least` requests."""
        from perfbench import trace
        prof = None
        phase = "before" if self.trace_plan else "done"
        start = time.perf_counter()
        deadline = start + self.seconds
        end = start
        i = 0
        while True:
            now = time.perf_counter()
            go = now < deadline
            traced = False
            if go and phase == "before" \
                    and now >= start + self.trace_plan[0] * self.seconds:
                phase, t_from, i_from = "tracing", now, i
            if go and phase == "tracing":
                traced = (now - t_from < self.trace_plan[1]
                          or i - i_from < self.trace_plan[2])
                phase = "tracing" if traced else "done"
            if self.decide is not None:
                go, traced = self.decide(go, traced)
            if prof is not None and not traced:
                self.raw = trace.stop(prof)
                prof = None
            if not go:
                break
            if traced and prof is None:
                prof = trace.start(self.cuda)
            t0 = time.perf_counter()
            self.attempted += 1
            try:
                if traced:
                    from torch.profiler import record_function
                    with record_function(trace.REQUEST):
                        out = self.serve(i)
                else:
                    out = self.serve(i)
                ok = self.check(out)
            except Exception as exc:            # a failed request
                out, ok = None, False
                if len(self.errors) < 3:
                    self.errors.append(f"{type(exc).__name__}: {exc}")
            end = time.perf_counter()
            if not ok:
                self.failed += 1
            self.latencies.append(end - t0)
            self.indices.append(i)
            self.outputs.append(out if ok else None)
            i += 1
        if prof is not None:
            self.raw = trace.stop(prof)
        self.window_s = end - start


def output_check(keyset: dict, shape):
    """A well-formed output: u64 ciphertexts of the request's shape."""
    want = tuple(shape) + (
        keyset["glwe_dimension"] * keyset["polynomial_size"] + 1,)

    def check(out) -> bool:
        return (isinstance(out, np.ndarray) and out.dtype == np.uint64
                and out.shape == want)
    return check


# ---------------------------------------------------------------------------
# the judgement
# ---------------------------------------------------------------------------

def mismatches(got, want) -> int:
    """Values of a decoded output that differ from the clear function's;
    a tuple output is compared member by member."""
    if isinstance(want, tuple):
        return sum(mismatches(g, w) for g, w in zip(got, want))
    return int(np.count_nonzero(np.asarray(got) != np.asarray(want)))


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(a, b))


def judge(cell: Cell, seed: int, clear: list, window: Window,
          lookups_per_request: int, keyset: dict = None) -> dict:
    """Decrypt every output of the window with the secret key derived
    again from the seed, and hold it to the reference's clear function.

    The program is deterministic: a pool entry served again gives the same
    ciphertexts, so a lookup that decrypts wrong once does so at every
    serving.  So `wrong` counts the wrong values of each entry's first
    serving, and the configuration's declared error probability per
    lookup bounds it over the distinct lookups judged: the limit is the
    count that rate exceeds with probability FALSE_ALARM.  `inconsistent`
    counts the servings that decode otherwise than their entry's first."""
    from perfbench.reference import keys
    ref = cell.reference
    secret = getattr(ref, "secret_key", keys.secret_key)(
        seed, keyset or cell.config["keyset"])
    read_output = getattr(ref, "read_output", keys.read_output)
    first = {}
    wrong = inconsistent = judged = 0
    for i, out in zip(window.indices, window.outputs):
        if out is None:
            continue
        entry = i % len(clear)
        got = read_output(secret, out, cell.config["output"])
        judged += 1
        if entry in first:
            inconsistent += int(not same(got, first[entry]))
            continue
        first[entry] = got
        wrong += mismatches(got, ref.clear(*clear[entry]))
    lookups = len(first) * lookups_per_request
    p_error = float(cell.config["configuration"]["p_error"])
    limit = poisson_limit(lookups * p_error)
    checks = {"failed": {"value": window.failed, "limit": 0},
              "wrong": {"value": wrong, "limit": limit},
              "inconsistent": {"value": inconsistent, "limit": 0},
              "judged": {"value": judged, "limit": 1}}
    correct = (window.failed <= 0 and wrong <= limit and inconsistent <= 0
               and judged >= 1)
    return {"correct": correct, "checks": checks, "lookups": lookups,
            "entries": len(first)}


def print_checks(checks: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error."""
    for name, c in checks.items():
        op = ">=" if name == "judged" else "<="
        print(f"check {name}: {c['value']} (must be {op} {c['limit']})",
              file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def window_records(window: Window, lookups_per_request: int,
                   setup_s: float) -> dict:
    lat = window.latencies
    return {"setup_s": setup_s, "window_s": window.window_s,
            "latencies_s": lat, "completed": len(lat) - window.failed,
            "lookups": (len(lat) - window.failed) * lookups_per_request}


def read_metrics(cell: Cell, names: list, records: dict) -> dict:
    """Each metric's reader over the records; a reader that finds nothing
    returns None and the metric is left out of the line."""
    spec_units = {m["name"]: m["unit"] for m in records["spec_metrics"]}
    out = {}
    for name in names:
        value = cell.reader(name)(records)
        if value is not None:
            out[name] = {"value": float(value), "unit": spec_units[name]}
    return out


def rank_trace(raw, lookups_per_request: int, blind_rotates: list,
               keyset: dict) -> dict:
    """One rank's traced stretch, summarised, with what its roofline
    needs: the stretch's lookups and blind rotates."""
    from perfbench import trace
    rec = trace.reduce(raw, br_kernel_names()) if raw else {"requests": 0}
    rec["lookups"] = rec["requests"] * lookups_per_request
    rec["blind_rotates"] = [[c * rec["requests"], b]
                            for c, b in blind_rotates]
    rec["keyset"] = keyset
    return rec


def breakdown(ranks: list) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, averaged over the ranks."""
    out = {}
    for key in ("device_ops", "idle_gaps"):
        acc = {}
        for r in ranks:
            for name, s in r.get(key, []):
                acc[name] = acc.get(name, 0.0) + s / len(ranks)
        out[key] = [[n, s] for n, s in sorted(acc.items(),
                                              key=lambda kv: -kv[1])[:10]]
    return out


def device_record(cuda: bool, chips: int, peak: int, ranks=None) -> dict:
    import torch
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if cuda and ranks:
        traced = [r for r in ranks if r.get("requests")]
        if traced:
            dev["busy_s"] = statistics.fmean(r["busy_ns"] / 1e9
                                             for r in traced)
            dev["window_s"] = statistics.fmean(r["window_ns"] / 1e9
                                               for r in traced)
    return dev


# ---------------------------------------------------------------------------
# one chip
# ---------------------------------------------------------------------------

def rehearsal_overrides(rehearse: dict) -> dict:
    """A CPU rehearsal's changes to a cell: {"params": the name of one of
    the program's insecure parameter sets, or the fields of one (none: the
    configuration's own), "shape": a smaller request}."""
    if not rehearse:
        return {}
    from concrete_tpu_torch import params as pp
    out = {}
    given = rehearse.get("params")
    if isinstance(given, dict):
        out["params"] = pp.CryptoParams(**given)
    elif given:
        out["params"] = getattr(pp, given)
    if "shape" in rehearse:
        out["shape"] = tuple(rehearse["shape"])
    return out


def run_one_chip(cell: Cell, seed: int, seconds: float, trace: bool,
                 t_start: float, rehearse: dict = None,
                 detail: dict = None, control: bool = False) -> dict:
    """One run of a one-chip cell; returns the result line's object.  A
    rehearsal runs on the CPU at an insecure parameter set and reads no
    metric.  A control run serves the window on ``control_key``'s key."""
    import torch
    overrides = rehearsal_overrides(rehearse)
    detail = {} if detail is None else detail
    cuda = not rehearse
    device = "cuda" if cuda else "cpu"
    spans = {"startup_s": time.perf_counter() - t_start}
    shape = tuple(overrides.get("shape", cell.shape))
    start_program(device, spans)
    circuit = compile_circuit(cell, device, spans, shape, overrides)
    keyset = keyset_of(circuit.client_specs.params)
    detail["keyset"] = keyset
    if keyset != cell.config["keyset"] and "params" not in overrides:
        print(f"the compiled keyset {keyset} is not the configuration's "
              f"{cell.config['keyset']}", file=sys.stderr, flush=True)
    lookups = int(circuit.programmable_bootstrap_count)
    brs = cell.build.blind_rotates(shape)
    if sum(c * b for c, b in brs) != lookups:
        raise RuntimeError(f"{cell.name}: the configuration lists blind "
                           f"rotates {brs}, the circuit counts {lookups} "
                           f"lookups a request")
    packed = make_keys(circuit, seed, spans, detail)
    if control:
        bsk, detail["control"] = control_key(circuit, packed[1])
        packed = (packed[0], bsk) + tuple(packed[2:])
        circuit._evaluation_keys = lambda: packed
    traffic = cell.traffic
    clear = draw_pool(cell, seed, int(traffic["pool"]), shape)
    t0 = time.perf_counter()
    pool = encrypt_pool(circuit, clear)
    spans["pool_s"] = time.perf_counter() - t0

    def serve(i):
        return circuit.run(*pool[i % len(pool)])
    check = cell.output_check(keyset, shape)
    t0 = time.perf_counter()
    for i in range(int(traffic["warmup"])):
        serve(i)
    if trace:                                   # the profiler's own start
        from perfbench import trace as tr
        tr.stop(tr.start(cuda))
    synchronize(circuit.device)
    spans["warmup_s"] = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_start
    plan = None
    if trace:
        t = traffic["trace"]
        plan = (t["after"], t["seconds"], t["least_requests"])
    window = Window(serve, check, seconds, plan, cuda)
    window.run()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    forbidden = forbidden_modules()
    ranks = [rank_trace(window.raw, lookups, brs, keyset)] if trace else []
    del serve, pool, circuit, packed
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    verdict = judge(cell, seed, clear, window, lookups,
                    keyset if rehearse else None)
    detail.update(spans=spans, setup_s=setup_s, judge_s=time.perf_counter()
                  - t0, window_s=window.window_s, errors=window.errors,
                  lookups_per_request=lookups, pool=len(clear),
                  requests=len(window.latencies), forbidden=forbidden,
                  first_cycle_ms=pool_cycle_ms(window, len(clear)))
    records = {"spec_metrics": [], "setup": spans, "ranks": ranks,
               "window": window_records(window, lookups, setup_s)}
    return finish(cell, trace, cuda, records, window, verdict, peak,
                  ranks, detail)


def pool_cycle_ms(window: Window, pool: int) -> dict:
    """Mean latency of the pool's first pass against the later passes: a
    program that kept anything between requests would serve repeated
    requests faster."""
    lat = window.latencies
    if len(lat) <= pool:
        return {}
    return {"first_pass_ms": 1e3 * statistics.fmean(lat[:pool]),
            "later_passes_ms": 1e3 * statistics.fmean(lat[pool:])}


def finish(cell: Cell, trace: bool, cuda: bool, records: dict,
           window: Window, verdict: dict, peak: int, ranks: list,
           detail: dict) -> dict:
    records["spec_metrics"] = (cell.spec["end_to_end"]
                               + cell.spec["per_layer"])
    metrics = {}
    if cuda:
        metrics = read_metrics(cell, cell.per_layer if trace
                               else cell.end_to_end, records)
    result = {"correct": verdict["correct"], "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": device_record(cuda, cell.chips, peak,
                                      ranks if trace else None)}
    if trace and cuda and ranks:
        result["breakdown"] = breakdown(ranks)
    result["checks"] = verdict["checks"]
    detail.update(checks=verdict["checks"], judged_entries=verdict["entries"],
                  distinct_lookups=verdict["lookups"])
    if trace:
        detail["ranks"] = [{k: v for k, v in r.items()
                            if k not in ("request_wall_ns",
                                         "request_busy_ns")}
                           for r in ranks]
    lat = window.latencies
    if lat:
        detail["latency_ms"] = {
            "p50": 1e3 * float(np.percentile(lat, 50)),
            "p95": 1e3 * float(np.percentile(lat, 95)),
            "beyond_p95": int(sum(x > np.percentile(lat, 95) for x in lat)),
            "max": 1e3 * max(lat)}
        detail["latencies_ms"] = [1e3 * x for x in lat]
    return result
