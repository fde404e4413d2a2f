"""The port's ``KeyValueDatabase`` (Concrete's key-value database, 32-bit
keys and values in 4-bit chunks) against its plain reference,
``models/kvdb_reference.py``, on the CPU.

Query, insert and replace compile through ``fhe.compiler`` at the
insecure ``TEST_PARAMS_TINY_WIDE`` at n = 16, N = 512 over 3 rows and
decrypt to the
reference on seeded random databases of distinct keys, a hit and a miss
each; the clear functions equal the reference at 256 rows; the query at
256 rows compiles at the default configuration to 17 lookups a row on the
fused CRT-NTT key, and on that key form (forced at a tiny N = 1024 set)
the spans and counters split a query into its three levels.  The real
keyset is not run here (minutes a query on
the CPU's plain kernels).
"""

import ast
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as fhe
from concrete_tpu_torch.models import KeyValueDatabase
from concrete_tpu_torch.models import kvdb_reference as ref
from concrete_tpu_torch.params import TEST_PARAMS_TINY_WIDE
from concrete_tpu_torch.utils import telemetry as tm

#: TEST_PARAMS_TINY_WIDE at n = 16, N = 512: at its own n = 32, N = 256
#: the modulus switch's rounding makes these 5-bit lookups err about once
#: in 30 queries (the noise model's circuit error 5.2%; here under 1e-6)
TINY = fhe.Configuration(forced_parameters=dataclasses.replace(
    TEST_PARAMS_TINY_WIDE, n_small=16, polynomial_size=512))
#: the same at N = 1024, the least N of the fused CRT-NTT key
TINY_1024 = fhe.Configuration(forced_parameters=dataclasses.replace(
    TEST_PARAMS_TINY_WIDE, polynomial_size=1024))
ENTRIES = 3
#: (operation, case): what the case draws (see `_case`)
CASES = [(op, case) for op in KeyValueDatabase.OPS
         for case in ("hit", "miss")]
_COMPILED: dict = {}


def _case(db: KeyValueDatabase, op: str, case: str, seed: int):
    """The clear arguments of one case on a state of distinct random keys
    and uniform values.  query, replace: a hit asks a row's key, a miss a
    key no row holds; insert: a hit has a free row (the last), a miss
    none."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 32, db.entries + 1, replace=False).tolist()
    values = rng.integers(0, 1 << 32, db.entries, dtype=np.uint64).tolist()
    free = op == "insert" and case == "hit"
    state = db.state_of(list(zip(keys, values))[:db.entries - free])
    hit = case == "hit" and op != "insert"
    key = keys[rng.integers(0, db.entries)] if hit else keys[-1]
    args = (state, db.encode_key(key))
    if op != "query":
        args += (db.encode_value(int(rng.integers(0, 1 << 32,
                                                  dtype=np.uint64))),)
    return args


def _reference(op: str, args) -> np.ndarray:
    return getattr(ref, op)(*(torch.as_tensor(a) for a in args)).numpy()


def _compiled(op: str):
    if op not in _COMPILED:
        circuit = KeyValueDatabase(ENTRIES).compile(TINY, "cpu", op)
        assert circuit.global_p_error < 1e-6
        circuit.keygen(seed=22)
        _COMPILED[op] = circuit
    return _COMPILED[op]


@pytest.mark.parametrize("op,case", CASES)
def test_encrypted_operation_decrypts_to_the_reference(op, case):
    db = KeyValueDatabase(ENTRIES)
    args = _case(db, op, case, seed=CASES.index((op, case)))
    want = _reference(op, args)
    if op == "query":
        assert want[0] == (case == "hit")
    else:
        assert np.array_equal(want, args[0]) == (case == "miss")
    got = _compiled(op).encrypt_run_decrypt(*args)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", KeyValueDatabase.OPS)
def test_clear_functions_equal_the_reference_at_256_rows(op):
    db = KeyValueDatabase(256)
    for seed, case in enumerate(("hit", "miss", "hit")):
        args = _case(db, op, case, seed=seed)
        assert np.array_equal(np.asarray(getattr(db, op)(*args)),
                              _reference(op, args))


def test_insert_fills_the_first_free_row_and_nothing_when_full():
    db = KeyValueDatabase(4)
    state = db.state_of([(7, 70), (9, 90)])
    state[0] = 0                           # rows 0, 2 and 3 are free
    key, value = db.encode_key(5), db.encode_value(50)
    out = _reference("insert", (state, key, value))
    assert out[0, 0] == 1 and db.decode(out[0, db.keys]) == 5
    assert db.decode(out[0, db.values]) == 50
    assert np.array_equal(out[1:], state[1:])
    full = db.state_of([(1, 2), (3, 4), (5, 6), (7, 8)])
    assert np.array_equal(_reference("insert", (full, key, value)), full)
    assert np.array_equal(db.insert(full, key, value), full)


def test_replace_sets_only_occupied_matching_rows():
    db = KeyValueDatabase(3)
    state = db.state_of([(7, 70), (9, 90), (7, 71)])
    state[2, 0] = 0                        # a stale row with key 7
    out = db.replace(state, db.encode_key(7), db.encode_value(5))
    assert [db.decode(out[i, db.values]) for i in range(3)] == [5, 90, 71]
    assert np.array_equal(out, _reference(
        "replace", (state, db.encode_key(7), db.encode_value(5))))


@pytest.mark.parametrize("number", [0, 1, 0x0F, 0x10, 0xDEADBEEF,
                                    (1 << 32) - 1])
def test_encode_decode_round_trip(number):
    db = KeyValueDatabase(1)
    key = db.encode_key(number)
    assert key.shape == (8,) and key.min() >= 0 and key.max() < 16
    assert db.decode(key) == number == db.decode(db.encode_value(number))
    assert key[-1] == number % 16              # most significant first
    with pytest.raises(ValueError):
        db.encode_key(1 << 32)


def test_query_at_256_rows_is_17_lookups_a_row_on_the_fused_key():
    """The default configuration: 128-bit security, p_error 6.3e-5."""
    from concrete_tpu_torch.optimizer.v0 import fused_ntt_preferred
    circuit = KeyValueDatabase(256).compile(device="cpu")
    assert circuit.programmable_bootstrap_count == 17 * 256 == 4352
    p = circuit.client_specs.params
    assert (p.n_small, p.glwe_dimension, p.polynomial_size, p.pbs_level,
            p.pbs_base_log, p.ks_level, p.ks_base_log) == (
                760, 1, 2048, 1, 23, 8, 2)
    assert fused_ntt_preferred(p, circuit.client_specs.output_width(0))
    assert circuit.client_specs.output_width(0) == 5
    assert tuple(circuit.client_specs.outputs[0].shape) == (9,)


def test_query_on_the_fused_key_counts_its_rows_by_form(monkeypatch):
    """The levels of 8 E, E and 8 E rows: the wide ones through the
    CRT-NTT loop (``pbs.crt_ntt_rows``), the middle one, at B = 3, through
    the fused persistent kernel's rule (``pbs.fused_latency_rows``)."""
    monkeypatch.setenv("CONCRETE_TPU_FUSED_NTT", "1")
    db = KeyValueDatabase(ENTRIES)
    circuit = db.compile(TINY_1024, device="cpu")
    assert circuit.global_p_error < 1e-6
    circuit.keygen(seed=23)
    args = _case(db, "query", "hit", seed=5)
    tm.reset()
    tm.enable()
    try:
        got = circuit.encrypt_run_decrypt(*args)
        snap = tm.snapshot()
    finally:
        tm.disable()
        tm.reset()
    assert np.array_equal(got, _reference("query", args))
    assert snap["counters"]["pbs.crt_ntt_rows"] == 16 * ENTRIES
    assert snap["counters"]["pbs.fused_latency_rows"] == ENTRIES
    assert [s["attrs"]["rows"] for s in snap["spans"]
            if s["name"] == "pbs"] == [8 * ENTRIES, ENTRIES, 8 * ENTRIES]
    assert [s["attrs"] for s in snap["spans"] if s["name"] == "pack"] == [
        {"form": "fused"}]


def test_reference_imports_torch_alone():
    tree = ast.parse(inspect.getsource(ref))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"torch", "__future__"}
