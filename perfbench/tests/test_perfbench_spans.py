"""``perfbench/spans.py``: the reduction of the port's spans on hand-built
events (idle put down to the innermost open span, the rest outside any
span, several threads, kernels to the span that launched them), the
readers of its metrics on hand-built records (rank skew, bytes a
request), and the command end to end on the CPU (one process, and four
gloo ranks)."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness, spans

SPANS = os.path.join(harness.HERE, "spans.py")
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
SERVE, OTHER = 1, 2                      # thread ids of the events


def events(annotations, kernels, launches=None, requests=((0, 100),),
           ops=()):
    return {"requests": [("perfbench.request", SERVE, s, e)
                         for s, e in requests],
            "annotations": annotations, "kernels": kernels,
            "launches": launches or {}, "ops": list(ops)}


def test_innermost_cuts_nested_spans_into_segments():
    segs = spans.innermost([(0, 100, "server.run"), (10, 60, "pbs"),
                            (20, 30, "pbs.keyswitch"), (70, 80, "node.x")])
    assert segs == [
        (0, 10, ("server.run",)), (10, 20, ("server.run", "pbs")),
        (20, 30, ("server.run", "pbs", "pbs.keyswitch")),
        (30, 60, ("server.run", "pbs")), (60, 70, ("server.run",)),
        (70, 80, ("server.run", "node.x")), (80, 100, ("server.run",))]


def test_idle_goes_to_the_innermost_span_of_the_serving_thread():
    ann = [("server.run", SERVE, 10, 90), ("node.tlu", SERVE, 20, 80),
           ("pbs", SERVE, 25, 75), ("pbs.keyswitch", SERVE, 25, 35),
           ("pbs.blind_rotate", SERVE, 40, 70),
           # another thread's spans take no idle of the request
           ("keygen.draws", OTHER, 0, 100),
           # a span of another program is not the port's
           ("aten::foo", SERVE, 0, 100)]
    kernels = [(30, 35, 7, 0), (45, 70, 8, 0)]       # busy 30-35, 45-70
    names = ["server.run", "node.tlu", "pbs", "pbs.keyswitch",
             "pbs.blind_rotate", "keygen.draws"]
    out = spans.reduce(events(ann, kernels, {7: (SERVE, 26),
                                             8: (SERVE, 41)}), names)
    idle = out["idle_ms_per_request"]
    # idle: 0-30 (0-10 out, 10-20 server, 20-25 node, 25-30 keyswitch),
    # 35-45 (35-40 pbs, 40-45 blind rotate), 70-100 (70-75 pbs, 75-80
    # node, 80-90 server, 90-100 out)
    assert idle == {"pbs": 20 / 1e6, "serve": 30 / 1e6,
                    "other": 0.0, "outside": 20 / 1e6}
    assert sum(idle.values()) == pytest.approx((100 - 30) / 1e6)
    table = {row[0]: row[1:] for row in out["table"]}
    # count, total, self, device-busy (inclusive), idle (all in ms)
    assert table["pbs.keyswitch"] == [1, 10 / 1e6, 10 / 1e6, 5 / 1e6,
                                      5 / 1e6]
    assert table["pbs"] == [1, 50 / 1e6, 10 / 1e6, 30 / 1e6, 10 / 1e6]
    assert table["server.run"][3] == 30 / 1e6
    assert table["keygen.draws"] == [1, 100 / 1e6, 100 / 1e6, 0.0, 0.0]
    assert "aten::foo" not in table


def test_idle_of_several_requests_is_a_mean_and_other_spans_count_apart():
    ann = [("server.run", SERVE, 0, 40), ("sharding.gather", SERVE, 40, 50),
           ("gather.sizes", SERVE, 42, 48),
           ("server.run", SERVE, 100, 130)]
    kernels = [(0, 30, 1, 0), (100, 130, 2, 0)]
    ops = [("cudaMemcpyAsync", SERVE, 52, 58),
           ("aten::cat", OTHER, 130, 140)]
    out = spans.reduce(events(ann, kernels, requests=((0, 60), (100, 140)),
                              ops=ops),
                       ["server.run", "sharding.gather", "gather.sizes"])
    idle = out["idle_ms_per_request"]
    # request 1: 30-40 serve, 40-50 other, 50-60 out; request 2: 130-140
    assert idle == {"pbs": 0.0, "serve": 5 / 1e6, "other": 5 / 1e6,
                    "outside": 10 / 1e6}
    assert out["requests"] == 2
    # the idle outside the spans, by the serving thread's operator there
    assert out["outside_by_op"] == [["cudaMemcpyAsync", 5 / 1e6],
                                    ["(no operator)", 5 / 1e6]]


def test_a_kernel_launched_by_the_linked_correlation_counts_too():
    ann = [("pbs", SERVE, 0, 50)]
    out = spans.reduce(events(ann, [(10, 20, 0, 5)], {5: (SERVE, 3)},
                              requests=((0, 50),)), ["pbs"])
    assert {row[0]: row[4] for row in out["table"]} == {"pbs": 10 / 1e6}


def test_no_traced_request_reduces_to_nothing():
    assert spans.reduce(events([], [], requests=()), []) == {}


def window(server_run, counters=None, requests=None):
    return {"requests": requests or len(server_run),
            "counters": counters or {}, "dropped": 0, "names": [],
            "per_request_ms": {"server.run": server_run,
                               "gather.sizes": [], "gather.to_host": []}}


def reader(name):
    return harness.load_module(os.path.join(harness.HERE, "metrics",
                                            name + ".py")).read


def test_rank_skew_is_the_slowest_rank_less_the_fastest_a_request():
    records = {"ranks": [{"window_spans": window([10.0, 12.0])},
                         {"window_spans": window([13.0, 11.0])},
                         {"window_spans": window([11.0, 20.0, 99.0])}]}
    assert reader("rank_skew_ms_per_request")(records) == pytest.approx(
        (3.0 + 9.0) / 2)
    one = {"ranks": [{"window_spans": window([10.0, 12.0])}]}
    assert reader("rank_skew_ms_per_request")(one) is None


def test_host_copy_is_rank_0s_counted_bytes_a_request():
    records = {"ranks": [
        {"window_spans": window([1.0] * 4, {"bytes.h2d": 3_000_000,
                                            "bytes.d2h": 1_000_000})},
        {"window_spans": window([1.0] * 4, {"bytes.h2d": 9})}]}
    assert reader("host_copy_mb_per_request")(records) == 1.0
    assert reader("host_copy_mb_per_request")({"ranks": [{}]}) is None


def test_idle_readers_average_the_ranks():
    records = {"ranks": [
        {"spans": {"idle_ms_per_request": {"pbs": 1.0, "serve": 4.0}}},
        {"spans": {"idle_ms_per_request": {"pbs": 3.0, "serve": 2.0}}},
        {"requests": 0}]}
    assert reader("idle_in_pbs_ms")(records) == 2.0
    assert reader("idle_in_serve_ms")(records) == 3.0
    assert reader("idle_in_pbs_ms")({"ranks": []}) is None


@pytest.mark.parametrize("cell,shape,ranks", [("tlu4.batch1024", 8, 1),
                                              ("tlu4.batch4096.4chip", 16,
                                               4)])
def test_the_command_records_spans_in_every_rank(cell, shape, ranks,
                                                 tmp_path):
    """A traced CPU rehearsal through the command: every rank's record has
    its stretch reduced and its window's spans and bytes; the bytes are
    the ciphertexts' (two inputs and one output of `shape` / ranks rows a
    rank; on several ranks, rank 0 also uploads its shard to the gather
    and downloads the whole batch)."""
    p = subprocess.run(
        [sys.executable, SPANS, "--workload", cell, "--seed", "2147483659",
         "--seconds", "1", "--trace", "1", "--rehearse",
         json.dumps({"params": "TEST_PARAMS_TINY_WIDE", "shape": [shape]}),
         "--detail", str(tmp_path / "d.json")],
        cwd=harness.ROOT, capture_output=True, text=True, env=ENV,
        timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
    detail = json.loads((tmp_path / "d.json").read_text())
    assert len(detail["ranks"]) == ranks
    word = 8 * 257                       # TINY_WIDE: k N + 1 = 257 words
    rows = shape // ranks
    for r in detail["ranks"]:
        assert r["spans"]["requests"] >= 1
        idle = r["spans"]["idle_ms_per_request"]
        assert idle["outside"] < 0.05 * sum(idle.values())
        w = r["window_spans"]
        assert w["dropped"] == 0 and "server.run" in w["names"]
        assert len(w["per_request_ms"]["server.run"]) == w["requests"]
    w0 = detail["ranks"][0]["window_spans"]
    h2d, d2h = 2 * rows, rows
    if ranks > 1:
        h2d, d2h = h2d + rows, d2h + shape
    assert w0["counters"] == {"bytes.h2d": w0["requests"] * h2d * word,
                              "bytes.d2h": w0["requests"] * d2h * word}
