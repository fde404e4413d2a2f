"""The roofline's counts at hand-worked shapes, and the metric readers and
the trace's reduction on hand-made records."""

import pytest

from perfbench import harness, roofline, trace


def test_blind_rotate_counts_by_hand():
    """n = 2, k = 1, N = 4, l = 3, B = 5.

    Key: n (k+1)^2 l N = 2 * 4 * 3 * 4 = 96 bytes at one byte a
    coefficient.  Accumulators: B (k+1) N = 5 * 2 * 4 = 40 words of 8
    bytes, read and written: 640 bytes.  Bytes 736.
    Operations: 2 B n (k+1)^2 l N = 2 * 5 * 2 * 4 * 3 * 4 = 960.
    Floor: max(736 / 3.35e12, 960 / 1.979e15) = 2.19701e-10 s, bytes-bound.
    """
    assert roofline.blind_rotate_bytes(2, 1, 4, 3, 5) == 736
    assert roofline.blind_rotate_ops(2, 1, 4, 3, 5) == 960
    assert roofline.blind_rotate_floor_s(2, 1, 4, 3, 5) == \
        pytest.approx(736 / 3.35e12, rel=1e-12)


def test_blind_rotate_floor_operations_bound():
    """n = 1000, k = 1, N = 1024, l = 4, B = 4096.

    Key 1000 * 4 * 4 * 1024 = 16,384,000 bytes; accumulators 2 * 4096 * 2 *
    1024 * 8 = 134,217,728; bytes 150,601,728: 44.956 us at 3.35 TB/s.
    Operations 2 * 4096 * 1000 * 16 * 1024 = 134,217,728,000: 67.821 us at
    1,979 TOP/s, the larger: operations-bound."""
    assert roofline.blind_rotate_bytes(1000, 1, 1024, 4, 4096) == 150601728
    assert roofline.blind_rotate_ops(1000, 1, 1024, 4, 4096) == \
        134217728000
    assert roofline.blind_rotate_floor_s(1000, 1, 1024, 4, 4096) == \
        pytest.approx(134217728000 / 1.979e15, rel=1e-12)


def test_trace_reduce_by_hand():
    """Two requests [0, 100) and [100, 200) ns.  Device activity: a blind
    rotate 10-40 and 30-60 (union 10-60), a copy 120-130, a torch kernel
    150-170.  Busy 50 + 10 + 20 = 80 of 200; request walls 100 and 100,
    busy 50 and 30; 3 kernels, 1 copy; blind-rotate union 50.  Idle gaps,
    each named by the host operator at its middle: 0-10 (at 5) and 60-120
    (at 90) in operator 'a' (0-100), 70 ns; 130-150 and 170-200 between
    operators, 50 ns."""
    raw = {"requests": [(0, 100), (100, 200)],
           "device": [("blind_rotate_latency_kernel", 10, 40),
                      ("blind_rotate_latency_kernel", 30, 60),
                      ("Memcpy HtoD", 120, 130), ("elementwise", 150, 170)],
           "host": [("a", 0, 100)]}
    r = trace.reduce(raw, ["blind_rotate_latency_kernel"])
    assert r["window_ns"] == 200 and r["busy_ns"] == 80
    assert r["request_wall_ns"] == [100, 100]
    assert r["request_busy_ns"] == [50, 30]
    assert (r["kernels"], r["copies"], r["br_busy_ns"]) == (3, 1, 50)
    gaps = dict(r["idle_gaps"])
    assert gaps["a"] == pytest.approx(70e-9)
    assert gaps["host: between operators"] == pytest.approx(50e-9)


def reader(name):
    return harness.load_module(
        f"{harness.HERE}/metrics/{name.split('.')[0]}.py").read


def test_readers_by_hand():
    rank = {"requests": 2, "request_wall_ns": [4e6, 6e6],
            "request_busy_ns": [3e6, 3e6], "window_ns": 10e6,
            "busy_ns": 6e6, "kernels": 30, "lookups": 10,
            "br_busy_ns": 2e6, "blind_rotates": [[2, 5]],
            "keyset": {"n_small": 2, "glwe_dimension": 1,
                       "polynomial_size": 4, "pbs_level": 3}}
    records = {"ranks": [rank], "setup": {"compile_s": 1.5},
               "gather_s": [0.002, 0.004],
               "window": {"setup_s": 9.0, "window_s": 2.0,
                          "latencies_s": [0.1, 0.2, 0.3, 0.4, 0.5],
                          "lookups": 5000}}
    # host: (1 + 3) / 2 = 2 ms; 30 kernels / 10 lookups; idle 1 - 6/10
    assert reader("host_ms_per_request.tput")(records) == pytest.approx(2.0)
    assert reader("kernels_per_lookup.p50")(records) == 3.0
    assert reader("device_idle_share.p50")(records) == pytest.approx(40.0)
    # two blind rotates of the first hand-worked shape over 2 ms
    assert reader("blind_rotate_roofline.p50")(records) == pytest.approx(
        100 * 2 * 736 / 3.35e12 / 2e-3)
    assert reader("lookups_per_s")(records) == 2500.0
    assert reader("request_p50_ms")(records) == pytest.approx(300.0)
    assert reader("request_p95_ms")(records) == pytest.approx(480.0)
    assert reader("setup_s")(records) == 9.0
    assert reader("compile_s")(records) == 1.5
    assert reader("gather_ms_per_request")(records) == pytest.approx(3.0)
    quiet = {"ranks": [{"requests": 0}], "setup": {}, "window": {}}
    for name in ("host_ms_per_request", "kernels_per_lookup",
                 "blind_rotate_roofline", "device_idle_share",
                 "gather_ms_per_request", "keygen_s"):
        assert reader(name)(quiet) is None


def test_poisson_limit_by_hand():
    """Mean 1: P(X > 0) = 0.632, P(X > 3) = 0.019; with a tail of 0.05
    the limit is 3.  A mean of 0 allows nothing."""
    assert harness.poisson_limit(1.0, 0.05) == 3
    assert harness.poisson_limit(0.0) == 0
    assert harness.poisson_limit(17.1) > 30
