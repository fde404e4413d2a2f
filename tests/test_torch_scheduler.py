"""The port's dataflow scheduler and ``run_async``, on CPU.

The cases of ``tests/test_scheduler.py`` on ``concrete_tpu_torch`` (a
future chain, overlapping tasks, a composition chain through
``run_async``, ``auto_schedule_run``), then: two ``run_async`` calls at
once on one circuit, their first calls among them, give the output
ciphertexts of sequential ``run`` calls and of the JAX package's circuit
on the same keys and ciphertexts; a task's exception comes out of
``Future.result()``; and the caches that first calls fill from several
threads at once (``Keys.evaluation_for``, ``MultiKeys.conversion_key``,
``ops/_build.library``) are filled once.  The port runs with
``device="cpu"``.
"""

import concurrent.futures
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation import keys as tkeys
from concrete_tpu_torch.compilation.scheduler import (DataflowScheduler,
                                                      default_scheduler)
from concrete_tpu_torch.ops import _build
from concrete_tpu_torch.params import CryptoParams as TParams

TINY = TParams(**dataclasses.asdict(TEST_PARAMS_TINY))
CFG = tfhe.Configuration(forced_parameters=TINY)


def test_future_arguments_form_a_chain():
    s = DataflowScheduler(max_workers=2)
    f1 = s.submit(lambda: 3)
    f2 = s.submit(lambda v: v * 2, f1)        # consumes f1's future
    f3 = s.submit(lambda a, b: a + b, f1, f2)
    assert f3.result() == 9
    assert s.map_unordered(lambda v: v + 1, [1, 2, 3]) == [2, 3, 4]
    s.shutdown()


def test_independent_tasks_overlap():
    s = DataflowScheduler(max_workers=4)

    def slow(v):
        time.sleep(0.2)
        return v

    t0 = time.time()
    futures = [s.submit(slow, i) for i in range(4)]
    assert [f.result() for f in futures] == [0, 1, 2, 3]
    elapsed = time.time() - t0
    assert elapsed < 0.6, f"tasks serialized: {elapsed:.2f}s"
    s.shutdown()


def test_task_exception_comes_out_of_result():
    s = DataflowScheduler(max_workers=2)

    def fails(v):
        raise ValueError(f"bad {v}")

    f1 = s.submit(fails, 1)
    f2 = s.submit(lambda v: v, f1)     # a consumer of the failed future
    with pytest.raises(ValueError, match="bad 1"):
        f1.result(timeout=10)
    with pytest.raises(ValueError, match="bad 1"):
        f2.result(timeout=10)
    s.shutdown()


def test_run_async_composition_chain():
    """Chained encrypted calls: the second run consumes the first's Future
    (output -> input composition without blocking the submitter).
    composable=True ties input/output encodings so the chain is valid."""
    cfg = tfhe.Configuration(forced_parameters=TINY, composable=True)

    @tfhe.compiler({"x": "encrypted"})
    def inc(x):
        return (x + 1) % 4

    circuit = inc.compile(range(4), cfg, device="cpu")
    circuit.keygen(seed=3)
    for _ in range(4):
        enc = circuit.encrypt(1)
        fut1 = circuit.run_async(enc)
        fut2 = default_scheduler().submit(circuit._run_sync, fut1)
        got = circuit.decrypt(fut2.result(timeout=120))
        if got == 3:
            return
    raise AssertionError(f"composition chain returned {got}, want 3")


def test_auto_schedule_run_returns_future():
    cfg = tfhe.Configuration(forced_parameters=TINY, auto_schedule_run=True)

    @tfhe.compiler({"x": "encrypted"})
    def f(x):
        return x + 1

    circuit = f.compile(range(4), cfg, device="cpu")
    circuit.keygen(seed=4)
    enc = circuit.encrypt(2)
    fut = circuit.run(enc)
    assert isinstance(fut, concurrent.futures.Future)
    assert circuit.decrypt(fut.result(timeout=120)) == 3


def _lookup(pkg):
    table = pkg.LookupTable([(3 * v + 1) % 8 for v in range(8)])

    @pkg.compiler({"x": "encrypted"})
    def f(x):
        return table[x]

    return f


def test_concurrent_run_async_equals_sequential_and_reference():
    """Two run_async calls at once on one fresh circuit (both first calls:
    one pack is built and shared), then sequential runs, then the JAX
    package's circuit, all on the same keys and ciphertexts: the output
    ciphertexts are equal bit for bit."""
    inputset = list(range(8))
    jc = _lookup(fhe).compile(inputset, fhe.Configuration(
        forced_parameters=TEST_PARAMS_TINY))
    tc = _lookup(tfhe).compile(inputset, CFG, device="cpu")
    jc.keygen(seed=5)
    tc.keygen(seed=5)
    specs = jc.client_specs
    rng = np.random.default_rng(2)
    cts = [jkg.encrypt_lwe_batch(
        rng, jc.keys.secret.lwe_big,
        jref.encode(np.asarray([v, (v + 3) % 8]), specs.input_width(0)),
        specs.params.glwe_std) for v in (1, 6)]
    futures = [tc.run_async(ct) for ct in cts]
    concurrent_outs = [f.result(timeout=120) for f in futures]
    assert len(tc.keys._packed) == 1
    for ct, out in zip(cts, concurrent_outs):
        assert out.dtype == np.uint64
        assert np.array_equal(out, tc.run(ct))
        assert np.array_equal(out, np.asarray(jc.run(ct)))


class _SlowFirstCall:
    """A stand-in for an expensive first build: counts its calls and
    sleeps, so that every thread that races past an unlocked check calls
    it too."""

    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        with self.lock:
            self.calls += 1
        time.sleep(0.05)
        return object()


def _race(fn, threads: int = 16):
    """fn() from `threads` threads released together, the interpreter's
    switch interval shortened; returns their results."""
    results, errors = [None] * threads, []
    start = threading.Barrier(threads)

    def worker(i):
        try:
            start.wait(timeout=30)
            results[i] = fn()
        except Exception as e:   # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker, args=(i,))
                for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    return results


def test_first_evaluation_for_calls_pack_once(monkeypatch):
    """Many threads' first Keys.evaluation_for at once leave one pack in
    the cache, and every thread gets it."""
    keys = tkeys.Keys(TINY)
    keys.generate(seed=9, device="cpu")
    slow = _SlowFirstCall()
    monkeypatch.setattr(tkeys, "pack_evaluation", slow)
    got = _race(lambda: keys.evaluation_for(3, device="cpu"))
    assert slow.calls == 1
    assert len(keys._packed) == 1
    assert all(g is got[0] for g in got)


def test_first_conversion_key_calls_split_once(monkeypatch):
    """MultiKeys.conversion_key from many threads at once: one split."""
    from concrete_tpu_torch.core import kernels_wop
    mk = tkeys.MultiKeys({2: TINY, 3: TINY}, {(2, 3): (2, 8)})
    mk.generate(seed=4, device="cpu")
    real = kernels_wop.split_u64_limbs
    slow = _SlowFirstCall()

    def split(x):
        slow()
        return real(x)

    monkeypatch.setattr(kernels_wop, "split_u64_limbs", split)
    got = _race(lambda: mk.conversion_key(2, 3, device="cpu"))
    assert slow.calls == 1
    assert all(g is got[0] for g in got)


def test_first_library_calls_build_once(monkeypatch):
    """ops/_build.library() from many threads at once: one build."""
    lib = object()
    slow = _SlowFirstCall()

    def load():
        slow()
        _build._LIB = lib

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_load", load)
    got = _race(_build.library)
    assert slow.calls == 1
    assert all(g is lib for g in got)


def test_launch_count_loses_no_update(monkeypatch):
    """_build.count from many threads: no increment is lost."""
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())

    def many():
        for _ in range(2000):
            _build.count("k")

    _race(many, threads=8)
    assert _build.LAUNCHES["k"] == 8 * 2000
