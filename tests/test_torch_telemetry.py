"""The port's spans and counters (``concrete_tpu_torch/utils/telemetry.py``)
on the CPU, at the insecure TINY parameters: nothing is recorded while
tracing is off and the outputs are the same bits either way; a request's
span tree, its one request id (also on the dataflow scheduler's threads)
and its parents; the byte counters against the copied arrays; the spans
as profiler annotations around the operators they launched; the set-up
seconds of ``Keys`` as their spans' durations; compile's stages; the
bounded buffer."""

import threading

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as fhe
from concrete_tpu_torch.params import TEST_PARAMS_TINY
from concrete_tpu_torch.utils import telemetry as tm

ROWS = 6                       # above LATENCY_BATCH_MAX: the banded scan
TABLE = [(3 * v + 1) % 16 for v in range(16)]
PBS_STAGES = ["pbs.keyswitch", "pbs.init", "pbs.blind_rotate",
              "pbs.extract"]


@pytest.fixture
def tracing():
    tm.reset()
    tm.enable()
    try:
        yield
    finally:
        tm.disable()
        tm.reset()


def _compile():
    table = fhe.LookupTable(TABLE)

    @fhe.compiler({"x": "encrypted", "y": "encrypted"})
    def table_sub(x, y):
        return table[x] - y

    rng = np.random.default_rng(0)
    inputset = [(rng.integers(0, 16, ROWS), rng.integers(0, 16, ROWS))
                for _ in range(8)]
    return table_sub.compile(
        inputset, fhe.Configuration(forced_parameters=TEST_PARAMS_TINY),
        device="cpu")


@pytest.fixture(scope="module")
def traced_setup():
    """The circuit compiled and keyed with tracing on, the spans of each,
    and one encrypted request."""
    tm.reset()
    tm.enable()
    try:
        circuit = _compile()
        compile_spans = tm.snapshot()["spans"]
        tm.reset()
        circuit.keygen(force=True, seed=11)
        circuit._evaluation_keys()
        keygen_spans = tm.snapshot()["spans"]
    finally:
        tm.disable()
        tm.reset()
    x = np.arange(ROWS) % 16
    y = (5 * np.arange(ROWS)) % 16
    return circuit, compile_spans, keygen_spans, circuit.encrypt(x, y)


def by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_the_outputs_are_the_same_bits(
        traced_setup):
    circuit, _, _, enc = traced_setup
    tm.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = circuit.run(*enc)
    assert tm.snapshot() == {"spans": [], "counters": {}, "dropped": 0}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & {"circuit.run", "server.run", "pbs"}
    tm.enable()
    try:
        on = circuit.run(*enc)
        assert tm.snapshot()["spans"]
    finally:
        tm.disable()
        tm.reset()
    assert off.dtype == on.dtype == np.uint64
    assert np.array_equal(off, on)


def check_request_tree(spans) -> int:
    """The spans of one ``Circuit.run`` of table_sub: their tree, and one
    request id, the outermost span's; returns that span's id."""
    names = by_name(spans)
    ids = {s["id"]: s for s in spans}
    assert len({s["id"] for s in spans}) == len(spans)
    (run,) = names["circuit.run"]
    assert {s["request"] for s in spans} == {run["request"]}

    def parent(name):
        (s,) = names[name]
        return ids[s["parent"]]["name"] if s["parent"] in ids else None

    assert parent("circuit.keys") == parent("server.run") == "circuit.run"
    for name in ("server.upload", "node.tlu", "node.subtract",
                 "server.download"):
        assert parent(name) == "server.run"
    assert parent("pbs") == "node.tlu"
    assert names["pbs"][0]["attrs"] == {"rows": ROWS}
    for name in PBS_STAGES:
        assert parent(name) == "pbs"
    assert names["pbs.blind_rotate"][0]["attrs"] == {"form": "banded_scan"}
    assert sorted(names) == sorted(
        ["circuit.run", "circuit.keys", "server.run", "server.upload",
         "node.tlu", "node.subtract", "server.download", "pbs"]
        + PBS_STAGES)
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] in ids:
            p = ids[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
    return run["id"]


def test_a_request_is_one_tree_under_one_request_id(traced_setup, tracing):
    circuit, _, _, enc = traced_setup
    circuit.run(*enc)
    spans = tm.snapshot()["spans"]
    run_id = check_request_tree(spans)
    assert by_name(spans)["circuit.run"][0]["request"] == run_id
    assert by_name(spans)["circuit.run"][0]["parent"] is None
    assert {s["rank"] for s in spans} == {0}
    assert len({s["thread"] for s in spans}) == 1


def test_run_async_spans_join_their_request_on_the_scheduler_threads(
        traced_setup, tracing):
    circuit, _, _, enc = traced_setup
    circuit.run_async(*enc).result(timeout=120)
    spans = tm.snapshot()["spans"]
    check_request_tree(spans)
    assert {s["thread"] for s in spans} != {threading.get_ident()}
    # a request opened by the submitter covers its tasks' spans
    tm.reset()
    with tm.request("outer") as outer:
        futures = [circuit.run_async(*enc) for _ in range(2)]
        for f in futures:
            f.result(timeout=120)
    spans = tm.snapshot()["spans"]
    assert {s["request"] for s in spans} == {outer.id}
    runs = by_name(spans)["circuit.run"]
    assert [s["parent"] for s in runs] == [outer.id, outer.id]
    for run in runs:
        check_request_tree(subtree(run, spans))


def subtree(root: dict, spans) -> list:
    out, frontier = [root], {root["id"]}
    while frontier:
        children = [s for s in spans if s["parent"] in frontier]
        out += children
        frontier = {s["id"] for s in children}
    return out


def test_byte_counters_are_the_copied_arrays_bytes(traced_setup, tracing):
    circuit, _, _, enc = traced_setup
    out = circuit.run(*enc)
    counters = tm.snapshot()["counters"]
    assert counters == {"bytes.h2d": sum(a.nbytes for a in enc),
                        "bytes.d2h": out.nbytes}
    width = TEST_PARAMS_TINY.glwe_dimension \
        * TEST_PARAMS_TINY.polynomial_size + 1
    assert counters["bytes.h2d"] == 2 * ROWS * width * 8


def test_spans_are_annotations_around_the_operators_they_launched(
        traced_setup, tracing):
    circuit, _, _, enc = traced_setup
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        circuit.run(*enc)
    spans = tm.snapshot()["spans"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    marks = by_name([{"name": e.name(), "thread": e.start_thread_id(),
                      "start": e.start_ns(),
                      "end": e.start_ns() + e.duration_ns()}
                     for e in events if e.is_user_annotation()])
    ops = [(e.start_thread_id(), e.start_ns(),
            e.start_ns() + e.duration_ns()) for e in events
           if e.name().startswith("aten::")]
    for name, recorded in by_name(spans).items():
        assert len(marks.get(name, [])) == len(recorded), name
    # every stage of the PBS launches operators inside its annotation
    for name in PBS_STAGES + ["server.upload", "node.subtract"]:
        (m,) = marks[name]
        assert any(t == m["thread"] and m["start"] <= s and e <= m["end"]
                   for t, s, e in ops), name
    # an operator that starts inside a span's annotation ends inside it
    (m,) = marks["server.run"]
    for t, s, e in ops:
        if t == m["thread"] and m["start"] <= s < m["end"]:
            assert e <= m["end"]


def test_keys_setup_seconds_are_their_spans_durations(traced_setup):
    circuit, _, spans, _ = traced_setup
    names = by_name(spans)
    seconds = circuit.keys.setup_seconds

    def total(name):
        return sum(s["end_ns"] - s["start_ns"] for s in names[name]) / 1e9

    (keygen,) = names["keygen"]
    (encrypt,) = names["keygen.encrypt"]
    assert encrypt["parent"] == keygen["id"]
    for name in ("keygen.to_host", "keygen.ksk"):
        assert names[name][0]["parent"] == keygen["id"]
    for name in ("keygen.draws", "keygen.product"):
        assert {s["parent"] for s in names[name]} == {encrypt["id"]}
    assert len({s["thread"] for s in names["keygen.draws"]}) >= 1
    assert seconds["bsk"]["draws_s"] == pytest.approx(
        total("keygen.draws"), rel=1e-12, abs=1e-12)
    assert seconds["bsk"]["product_s"] == pytest.approx(
        total("keygen.product"), rel=1e-12, abs=1e-12)
    assert seconds["bsk"]["wall_s"] == total("keygen.encrypt")
    assert seconds["bsk"]["to_host_s"] == total("keygen.to_host")
    assert seconds["ksk_s"] == total("keygen.ksk")
    assert seconds["pack_s"] == total("pack")


def test_compile_is_one_span_with_its_four_stages(traced_setup):
    _, spans, _, _ = traced_setup
    names = by_name(spans)
    (top,) = names["compile"]
    stages = sorted((s for s in spans if s["parent"] == top["id"]),
                    key=lambda s: s["start_ns"])
    assert [s["name"] for s in stages] == [
        "compile.trace", "compile.bounds", "compile.optimize",
        "compile.lower"]
    for a, b in zip(stages, stages[1:]):
        assert a["end_ns"] <= b["start_ns"]


def test_the_buffer_keeps_its_capacity_and_counts_what_it_drops(
        monkeypatch, tracing):
    monkeypatch.setattr(tm, "_RECORDER", tm.Recorder(capacity=3))
    for i in range(5):
        with tm.span("s", i=i):
            pass
    tm.count("c", 2)
    tm.count("c", 3)
    snap = tm.snapshot()
    assert [s["attrs"] for s in snap["spans"]] == [{"i": 0}, {"i": 1},
                                                   {"i": 2}]
    assert snap["dropped"] == 2 and snap["counters"] == {"c": 5}
    tm.reset()
    assert tm.snapshot() == {"spans": [], "counters": {}, "dropped": 0}
