"""``kvdb32.query256`` end to end on the CPU: the key-value query at an
insecure tiny set over 4 rows (n = 16, N = 512), faults planted under its timed path, and
the control on the key form the cell runs on the card (the fused CRT-NTT
key, one prime fewer), forced at N = 1024.  Its files against each
other: the draw, the blind rotates, the output's form and the clear
function against the program's own plain reference."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench import harness

RUN = os.path.join(harness.HERE, "run.py")
PLANT = os.path.join(harness.HERE, "tests", "fault_plant.py")
CELL = "kvdb32.query256"
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
#: the program's TEST_PARAMS_TINY_WIDE at n = 16, N = 512: at its own n =
#: 32, N = 256 the circuit's 5-bit lookups err about once in 30 queries
#: (its noise model's 5.2%), which the judgement rightly counts
TINY = {"params": {"n_small": 16, "glwe_dimension": 1,
                   "polynomial_size": 512, "pbs_level": 2,
                   "pbs_base_log": 12, "ks_level": 2, "ks_base_log": 8,
                   "lwe_std": 2.0 ** -30, "glwe_std": 2.0 ** -40,
                   "security_level": 0},
        "shape": [4]}
#: a quiet insecure set at the fused key's least N: its pack keeps two
#: primes, and the control's one prime breaks the error probability
QUIET_1024 = {"params": {"n_small": 16, "glwe_dimension": 1,
                         "polynomial_size": 1024, "pbs_level": 3,
                         "pbs_base_log": 10, "ks_level": 3, "ks_base_log": 8,
                         "lwe_std": 1e-11, "glwe_std": 1e-13,
                         "security_level": 0},
              "shape": [4]}
SEED = 2147483659


def rehearse(tmp_path, params=TINY, fault=None, control=False, env=None,
             trace=0):
    cmd = [sys.executable] + ([PLANT, fault] if fault else [RUN]) + [
        "--workload", CELL, "--seed", str(SEED), "--seconds", "1",
        "--trace", str(trace), "--rehearse", json.dumps(params),
        "--control", str(int(control)),
        "--detail", str(tmp_path / "detail.json")]
    p = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True,
                       text=True, env={**ENV, **(env or {})}, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    detail = json.loads((tmp_path / "detail.json").read_text())
    return json.loads(p.stdout.strip().splitlines()[-1]), detail


def test_rehearsal_is_correct_and_reads_no_device_metric(tmp_path):
    result, detail = rehearse(tmp_path, trace=1)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert detail["lookups_per_request"] == 17 * 4
    assert detail["forbidden"] == []


def test_the_first_served_entry_is_a_hit():
    """The premise of the `half` fault below: the window's first request
    asks a row's key.  Half of each level repeated leaves a hit in the
    second half of the rows unmatched, and counts one in the first half
    twice; a miss would read right."""
    cell = harness.Cell(harness.load_spec(), CELL)
    state, key = harness.draw_pool(cell, SEED, 8, (4,))[0]
    assert (state[:, 1:9] == key).all(axis=1).sum() == 1


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_fault_under_the_timed_path_is_not_correct(fault, tmp_path):
    result, _ = rehearse(tmp_path, fault=fault)
    assert result["attempted"] >= 1
    assert result["correct"] is False, result["checks"]


def test_control_on_the_fused_key_is_not_correct_and_the_program_is(
        tmp_path):
    fused = {"CONCRETE_TPU_FUSED_NTT": "1"}
    base, detail = rehearse(tmp_path, params=QUIET_1024, env=fused)
    assert base["correct"] is True, base["checks"]
    assert detail.get("control") is None
    result, detail = rehearse(tmp_path, params=QUIET_1024, env=fused,
                              control=True)
    assert detail["control"]["primes"] == 1
    assert result["correct"] is False
    assert result["checks"]["wrong"]["value"] > 3 * max(
        1, base["checks"]["wrong"]["value"])


def test_draw_blind_rotates_output_and_clear_function():
    import torch

    from concrete_tpu_torch.models import kvdb_reference
    cell = harness.Cell(harness.load_spec(), CELL)
    assert cell.shape == (256,)
    assert sum(c * b for c, b in cell.build.blind_rotates(cell.shape)) \
        == 17 * 256
    pool = harness.draw_pool(cell, SEED, 64)
    assert pool[0][0].shape == (256, 17) and pool[0][1].shape == (8,)
    assert np.array_equal(pool[3][0], harness.draw_pool(cell, SEED, 4)[3][0])
    hits = 0
    for state, key in pool:
        assert (state[:, 0] == 1).all()
        assert 0 <= state.min() and state.max() < 16
        assert len({tuple(r) for r in state[:, 1:9]}) == 256
        want = kvdb_reference.query(torch.as_tensor(state),
                                    torch.as_tensor(key)).numpy()
        got = cell.reference.clear(state, key)
        assert np.array_equal(got, want)
        hits += int(got[0])
    assert 32 <= hits <= 60                   # 3/4 of 64 is 48
    check = cell.output_check(cell.config["keyset"], cell.shape)
    assert check(np.zeros((9, 2049), dtype=np.uint64))
    assert not check(np.zeros((256, 2049), dtype=np.uint64))
