"""BENCHMARK.json against the benchmark's rules, and every cell against its
files: configuration, reference, traffic mix and metric readers."""

import json
import os
import re

import pytest

from perfbench import harness

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_entries_have_only_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    names = [e["name"] for e in SPEC["configs"] + SPEC["workloads"]
             + METRICS]
    assert len(names) == len(set(names))


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.Cell(SPEC, cell)
    for fn in ("build", "draw", "blind_rotates"):
        assert callable(getattr(c.build, fn))
    assert callable(c.reference.clear)
    assert c.traffic["loop"] == "closed" and c.traffic["clients"] == 1
    assert c.traffic["pool"] >= 1 and c.traffic["warmup"] >= 1
    assert {"after", "seconds", "least_requests"} <= set(c.traffic["trace"])
    for name in c.end_to_end + c.per_layer:
        assert callable(c.reader(name))
    assert c.config["keyset"] and c.config["output"]["bits"] >= 1
    assert (c.traffic.get("sharding") == "batch") == (c.chips > 1)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = harness.Cell(SPEC, cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer


def test_every_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_file(entry):
    assert entry["file"].startswith("perfbench/")
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg, key
    assert cfg["configuration"]["security_level"] == 128
    assert any(entry["name"] == w["config"] for w in SPEC["workloads"])


def test_files_under_paths_are_named_from_name_characters():
    for top, _, files in os.walk(os.path.join(harness.ROOT, "perfbench")):
        if "__pycache__" in top:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(top, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
