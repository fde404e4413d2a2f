"""The harness end to end on the CPU: the request loop at insecure tiny
parameters, faults planted under the timed path, the control, the runs
that must fail, and, on a card only, one short run of each cell.

On the CPU every run is a rehearsal: ``--rehearse`` names the parameter
set and the request shape, and no metric is read."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

RUN = os.path.join(harness.HERE, "run.py")
PLANT = os.path.join(harness.HERE, "tests", "fault_plant.py")
SPEC = harness.load_spec()
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
TINY = {"tlu4.batch1024": {"params": "TEST_PARAMS_TINY_WIDE", "shape": [8]},
        "tlu4.single": {"params": "TEST_PARAMS_TINY_WIDE"},
        "tlu4.batch4096.4chip": {"params": "TEST_PARAMS_TINY_WIDE",
                                 "shape": [16]}}
#: a quiet insecure set at which the truncation rule's next limb breaks
#: the error probability, as it does at the configurations' own keysets
QUIET = {"n_small": 16, "glwe_dimension": 1, "polynomial_size": 512,
         "pbs_level": 3, "pbs_base_log": 10, "ks_level": 3, "ks_base_log": 8,
         "lwe_std": 1e-11, "glwe_std": 1e-13, "security_level": 0}


def rehearse(cell, tmp_path, seed=2147483659, seconds=1, trace=0,
             fault=None, params=None, control=False):
    cmd = [sys.executable] + ([PLANT, fault] if fault else [RUN]) + [
        "--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
        "--trace", str(trace), "--rehearse",
        json.dumps(params or TINY[cell]), "--control", str(int(control)),
        "--detail", str(tmp_path / "detail.json")]
    p = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                       text=True, env=ENV, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("cell", list(TINY))
def test_rehearsal_is_correct_and_reads_no_device_metric(cell, tmp_path):
    result, err = rehearse(cell, tmp_path, trace=1)
    assert result["correct"] is True, result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"] and "breakdown" not in result
    assert list(result)[-1] == "checks"
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") for line in last)
    detail = json.loads((tmp_path / "detail.json").read_text())
    assert detail["forbidden"] == []
    assert detail["requests"] == result["attempted"]


FAULTS = [("tlu4.batch1024", "unchanged"), ("tlu4.batch1024", "half"),
          ("tlu4.batch1024", "altered"), ("tlu4.batch1024", "once"),
          ("tlu4.single", "unchanged"),
          ("tlu4.single", "altered"), ("tlu4.batch4096.4chip", "unchanged"),
          ("tlu4.batch4096.4chip", "half"),
          ("tlu4.batch4096.4chip", "altered"),
          ("tlu4.batch4096.4chip", "exchange")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, tmp_path):
    # `once` needs a second pass through the pool
    result, _ = rehearse(cell, tmp_path, fault=fault,
                         seconds=1 if fault != "once" else 15)
    assert result["attempted"] >= 1
    assert result["correct"] is False, result["checks"]


#: the seeds of the control test: the program's, then the control's
CONTROL_SEEDS = {"tlu4.batch1024": ([2147483659], [2147483693, 11, 12]),
                 "tlu4.batch4096.4chip": ([2147483659], [2147483693])}


@pytest.mark.parametrize("cell", list(CONTROL_SEEDS))
def test_control_is_not_correct_and_the_program_is(cell, tmp_path):
    """The control (``run.py --control 1``: the timed path on the key one
    limb below the truncation rule; on four ranks, packed on rank 0 and
    broadcast) at a size a test holds: a quiet insecure set, 16 lookups a
    request."""
    quiet = {"params": QUIET, "shape": [16]}
    program, control = CONTROL_SEEDS[cell]
    base, _ = rehearse(cell, tmp_path, seed=program[0], seconds=0.5,
                       params=quiet)
    assert base["correct"] is True, base["checks"]
    assert json.loads((tmp_path / "detail.json").read_text()).get(
        "control") is None
    for seed in control:
        result, _ = rehearse(cell, tmp_path, seed=seed, seconds=0.5,
                             params=quiet, control=True)
        detail = json.loads((tmp_path / "detail.json").read_text())
        assert detail["control"] == {"truncate_limbs": 5}
        assert result["correct"] is False
        assert result["checks"]["wrong"]["value"] > 3 * max(
            1, base["checks"]["wrong"]["value"])


def test_without_a_card_the_run_fails(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, RUN, "--workload", "tlu4.single",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "tlu4.single", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--rehearse",
                        json.dumps(TINY["tlu4.single"])],
                       cwd=tmp_path, capture_output=True, text=True,
                       env={**ENV, "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_run_loads_no_module_of_jax(tmp_path):
    """run.py's import graph in a fresh interpreter, the whole rehearsal
    through it, held by whole top-level names: concrete_tpu_torch is the
    program, concrete_tpu the JAX package."""
    code = ("import json, sys\n"
            "sys.argv = ['run.py', '--workload', 'tlu4.batch1024', "
            "'--seed', '5', '--seconds', '0.5', '--trace', '1', "
            "'--rehearse', json.dumps({'params': 'TEST_PARAMS_TINY_WIDE', "
            "'shape': [4]}), '--detail', sys.argv[1]]\n"
            "from perfbench import run, ranks, trace\n"
            "assert run.main(sys.argv[1:]) == 0\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code,
                        str(tmp_path / "d.json")], cwd=harness.ROOT,
                       capture_output=True, text=True, env=ENV, check=True)
    loaded = json.loads(p.stdout.strip().splitlines()[-1])
    assert "concrete_tpu_torch" in loaded
    for name in harness.FORBIDDEN:
        assert name not in loaded


@pytest.fixture
def card():
    """The cards, or a skip: decided here, when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.cuda.device_count()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_short_run_on_the_card(card, cell, tmp_path):
    chips = {w["name"]: w["chips"] for w in SPEC["workloads"]}[cell]
    if card < chips:
        pytest.skip(f"{cell} needs {chips} cards")
    p = subprocess.run([sys.executable, RUN, "--workload", cell, "--seed",
                        "2147483659", "--seconds", "3", "--trace", "0",
                        "--detail", str(tmp_path / "d.json")],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == chips
    assert "setup_s" in result["metrics"]
