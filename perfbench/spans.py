"""The port's own spans and counters in a run of the benchmark.

    python3 perfbench/spans.py <run.py arguments>

runs ``run.py`` with the port's tracing (``concrete_tpu_torch.utils.
telemetry``) on in every process, the ranks of a several-card cell
included, from before compile.  With ``--trace 0`` the run's line is
``run.py``'s, timed with the spans on: beside a plain ``run.py`` run it
gives the spans' cost.  With ``--trace 1`` each rank's traced stretch is
reduced again (``reduce``): the port's spans reach the profiler as
``record_function`` annotations on the device trace's clock, so each idle
stretch of the device inside a request is put down to the serving
thread's innermost open span, and each kernel to the span that launched
it (by correlation id).  Each rank's spans and counters of the whole
window are summarised too (``window_record``).  Both go into the rank's
record, so into the run's detail file, and the metrics of ``METRICS``
(readers under ``metrics/``) into the result line.

``run.py`` itself turns nothing on: these metrics are read only through
this command.
"""

from __future__ import annotations

import bisect
import collections
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

from perfbench.trace import union  # noqa: E402

#: the idle of a request by the layer of the innermost open port span
LAYERS = ("pbs", "serve", "other", "outside")
#: metric -> (unit, the end-to-end metric it moves: None for the idle
#: metrics, suffixed ".p50" or ".tput" as the cell reports request_p50_ms
#: or lookups_per_s)
METRICS = {"idle_in_pbs_ms": ("ms", None), "idle_in_serve_ms": ("ms", None),
           "rank_skew_ms_per_request": ("ms", "lookups_per_s"),
           "host_copy_mb_per_request": ("MB", "lookups_per_s")}
#: spans timed per request in the window record (rank skew, the gather)
PER_REQUEST = ("server.run", "gather.sizes", "gather.to_host")
_RUNTIME = ("cuda", "cu")


def layer_of(name: str) -> str:
    if name == "pbs" or name.startswith("pbs."):
        return "pbs"
    if name.startswith(("circuit.", "server.", "node.")):
        return "serve"
    return "other"


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------

def gaps(merged: list, lo: int, hi: int) -> list:
    """The parts of [lo, hi) that `merged` (sorted, disjoint) leaves out."""
    out, t = [], lo
    for s, e in merged:
        if e <= t:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def innermost(spans) -> list:
    """Nested spans of one thread, (start, end, name), as disjoint
    segments (start, end, stack): `stack` the names open there, innermost
    last.  A span that outlasts its parent is cut at the parent's end."""
    out, stack = [], []

    def emit(a, b):
        if stack and b > a:
            out.append((a, b, tuple(n for _, n in stack)))

    t = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end = stack[-1][0]
            emit(t, end)
            t = end
            stack.pop()
        if stack:
            emit(t, s)
            e = min(e, stack[-1][0])
        stack.append((e, name))
        t = s
    while stack:
        end = stack[-1][0]
        emit(t, end)
        t = end
        stack.pop()
    return out


def uncovered(segments: list, intervals: list) -> list:
    """The parts of `intervals` (sorted, disjoint) outside every segment
    (sorted, disjoint)."""
    return [g for a, b in intervals
            for g in gaps([(s, e) for s, e, _ in segments], a, b)]


def op_at(ops: list, starts: list, t: int) -> str:
    """The innermost of `ops` (name, start, end; sorted by start) running
    at time t: the latest-starting that contains it."""
    for name, s, e in reversed(ops[:bisect.bisect_right(starts, t)]):
        if e > t:
            return name
    return "(no operator)"


def overlap_by(segments: list, intervals: list, key) -> collections.Counter:
    """The length of `intervals` (sorted, disjoint) that each segment
    (sorted, disjoint) covers, summed by key(segment); the rest under
    None."""
    acc = collections.Counter()
    starts = [s for s, _, _ in segments]
    for a, b in intervals:
        covered = 0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segments) and segments[i][0] < b:
            s, e, stack = segments[i]
            part = min(e, b) - max(s, a)
            if part > 0:
                acc[key(stack)] += part
                covered += part
            i += 1
        acc[None] += (b - a) - covered
    return acc


# ---------------------------------------------------------------------------
# the traced stretch
# ---------------------------------------------------------------------------

def profile_events(prof, request_name: str) -> dict:
    """What the reduction needs of a stopped profiler: the host's user
    annotations (the requests' and the port's spans) with their threads,
    the runtime calls that launched device work by correlation id, and the
    device's activity with its correlation ids."""
    from torch.autograd import DeviceType
    requests, annotations, kernels, ops = [], [], [], []
    launches = {}
    for e in prof.profiler.kineto_results.events():
        begin = e.start_ns()
        end = begin + e.duration_ns()
        annotation = bool(getattr(e, "is_user_annotation",
                                  lambda: False)())
        if e.device_type() == DeviceType.CPU:
            if annotation:
                rec = (e.name(), e.start_thread_id(), begin, end)
                (requests if e.name() == request_name
                 else annotations).append(rec)
            else:
                ops.append((e.name(), e.start_thread_id(), begin, end))
                if e.correlation_id() and e.name().startswith(_RUNTIME):
                    launches[e.correlation_id()] = (e.start_thread_id(),
                                                    begin)
        elif e.device_type() == DeviceType.CUDA and not annotation \
                and end > begin:
            linked = getattr(e, "linked_correlation_id", lambda: 0)()
            kernels.append((begin, end, e.correlation_id(), linked))
    return {"requests": requests, "annotations": annotations,
            "launches": launches, "kernels": kernels, "ops": ops}


def reduce(events: dict, names, top: int = 40) -> dict:
    """One rank's traced stretch by the port's spans (those of `names`).

    ``idle_ms_per_request``: the device's idle time inside each request,
    by the layer (``LAYERS``) of the serving thread's innermost open port
    span, mean over the requests; their sum is the request's wall less its
    device-busy time.  ``outside_by_op``: the idle outside every port span
    by the host operator the serving thread ran there (ms a request, the
    largest).  ``table``: each span name's count, total and self ms (less
    its children), the device-busy ms of the kernels launched inside it,
    and the idle ms put down to it."""
    names = set(names)
    reqs = sorted(events["requests"], key=lambda r: r[2])
    if not reqs:
        return {}
    serving = reqs[0][1]
    by_thread = collections.defaultdict(list)
    for name, thread, s, e in events["annotations"]:
        if name in names:
            by_thread[thread].append((s, e, name))
    segments = {t: innermost(v) for t, v in by_thread.items()}
    busy = union([s, e] for s, e, _, _ in events["kernels"])
    idle = [g for _, _, s, e in reqs for g in gaps(busy, s, e)]
    mine = segments.get(serving, [])
    by_layer = overlap_by(mine, idle, lambda st: layer_of(st[-1]))
    by_span = overlap_by(mine, idle, lambda st: st[-1])
    n = len(reqs)
    per_request = {lay: by_layer.get(lay, 0) / n / 1e6
                   for lay in LAYERS[:-1]}
    per_request["outside"] = by_layer.get(None, 0) / n / 1e6
    ops = sorted(((name, s, e) for name, t, s, e in events.get("ops", [])
                  if t == serving), key=lambda o: o[1])
    op_starts = [s for _, s, _ in ops]
    outside = collections.Counter()
    for a, b in uncovered(mine, idle):
        outside[op_at(ops, op_starts, (a + b) // 2)] += b - a
    # count, total, self, device-busy, idle (ns) by name
    table = collections.defaultdict(lambda: [0, 0, 0, 0, 0])
    for spans in by_thread.values():
        for s, e, name in spans:
            table[name][0] += 1
            table[name][1] += e - s
    for segs in segments.values():
        for s, e, stack in segs:
            table[stack[-1]][2] += e - s
    starts = {t: [s for s, _, _ in segs] for t, segs in segments.items()}
    for s, e, corr, linked in events["kernels"]:
        where = events["launches"].get(corr) \
            or events["launches"].get(linked)
        if where is None or where[0] not in segments:
            continue
        thread, t = where
        segs = segments[thread]
        i = bisect.bisect_right(starts[thread], t) - 1
        if i >= 0 and segs[i][0] <= t < segs[i][1]:
            for name in set(segs[i][2]):
                table[name][3] += e - s
    for name, ns in by_span.items():
        if name is not None:
            table[name][4] += ns
    rows = sorted(([name] + [v[0]] + [x / 1e6 for x in v[1:]]
                   for name, v in table.items()), key=lambda r: -r[2])
    return {"requests": n, "idle_ms_per_request": per_request,
            "outside_by_op": [[k, v / n / 1e6]
                              for k, v in outside.most_common(8)],
            "table": rows[:top]}


# ---------------------------------------------------------------------------
# the whole window
# ---------------------------------------------------------------------------

def window_record(snapshot: dict, requests: int) -> dict:
    """A rank's spans and counters over the window: the requests served,
    the counters, the spans dropped, the span names, and the ms of each
    span of ``PER_REQUEST``, one entry a request, in order."""
    per = {name: [] for name in PER_REQUEST}
    for s in snapshot["spans"]:
        if s["name"] in per:
            per[s["name"]].append((s["start_ns"], s["end_ns"]))
    return {"requests": requests, "counters": dict(snapshot["counters"]),
            "dropped": snapshot["dropped"],
            "names": sorted({s["name"] for s in snapshot["spans"]}),
            "per_request_ms": {name: [(e - s) / 1e6 for s, e in sorted(v)]
                               for name, v in per.items()}}


def traced(records: dict) -> list:
    """The ranks' reductions of their traced stretches."""
    return [r["spans"] for r in records.get("ranks", [])
            if r and r.get("spans")]


def windows(records: dict) -> list:
    """The ranks' window records, rank 0 first."""
    return [r["window_spans"] for r in records.get("ranks", [])
            if r and r.get("window_spans")]


def idle_ms(records: dict, layer: str):
    """The mean over ranks of a request's idle device time in `layer`."""
    per = [s["idle_ms_per_request"][layer] for s in traced(records)]
    return statistics.fmean(per) if per else None


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def install() -> None:
    """Turn the port's tracing on in this process and hook the harness so
    that each rank's record carries its spans and the line their
    metrics."""
    from concrete_tpu_torch.utils import telemetry as tm

    from perfbench import harness, ranks, trace

    tm.enable()
    ranks.RANK_COMMAND = [sys.executable, os.path.abspath(__file__)]
    stop, window_run = trace.stop, harness.Window.run
    rank_trace, read_metrics = harness.rank_trace, harness.read_metrics

    def stop_keeping_events(prof):
        raw = stop(prof)
        raw["port"] = profile_events(prof, trace.REQUEST)
        return raw

    def run_window(self):
        tm.reset()
        window_run(self)
        if self.raw is not None:
            self.raw["port_window"] = window_record(
                tm.snapshot(), len(self.latencies))

    def rank_trace_with_spans(raw, *args):
        rec = rank_trace(raw, *args)
        if raw and "port" in raw and "port_window" in raw:
            rec["spans"] = reduce(raw["port"], raw["port_window"]["names"])
            rec["window_spans"] = raw["port_window"]
        return rec

    def read_with_spans(cell, names, records):
        out = read_metrics(cell, names, records)
        if names is cell.per_layer:
            suffix = ".p50" if "request_p50_ms" in cell.end_to_end \
                else ".tput"
            for name, (unit, moves) in METRICS.items():
                if moves is not None and moves not in cell.end_to_end:
                    continue
                key = name + suffix if moves is None else name
                value = cell.reader(name)(records)
                if value is not None:
                    out[key] = {"value": float(value), "unit": unit}
        return out

    trace.stop = stop_keeping_events
    harness.Window.run = run_window
    harness.rank_trace = rank_trace_with_spans
    harness.read_metrics = read_with_spans


if __name__ == "__main__":
    from perfbench import run
    install()
    sys.exit(run.main(sys.argv[1:]))
