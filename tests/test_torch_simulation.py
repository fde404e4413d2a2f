"""The port's noise-accurate simulation against the JAX package's, on CPU.

The cases of ``tests/test_simulation_stats.py`` on ``concrete_tpu_torch``
(the error rate against the noise model's ``p_error``, univariate and
multivariate; leveled noise; the overflow warning; correlated noise),
then ``simulate_graph`` of the port equal to the JAX package's on the same
compiled function with the same ``np.random.default_rng(seed)``: a
univariate circuit, a multivariate one, a multi-partition one (the
default configuration, a frontier keyswitch), and the overflow warning's
text; and the configuration switches that route ``encrypt_run_decrypt``
to the simulator.  Simulation runs on the host: no keys, no device.
"""

import dataclasses
import re
import warnings

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.params import TEST_PARAMS_TINY
from concrete_tpu.simulation import simulate_graph as jsimulate

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.params import CryptoParams as TParams
from concrete_tpu_torch.simulation import simulate_graph as tsimulate

TINY = TParams(**dataclasses.asdict(TEST_PARAMS_TINY))
CFG = tfhe.Configuration(forced_parameters=TINY)


def test_simulation_error_rate_matches_model():
    table = tfhe.LookupTable(list(range(16)))

    @tfhe.compiler({"x": "encrypted"})
    def f(x):
        return table[x]

    circuit = f.compile(range(16), CFG, device="cpu")
    pe_model = circuit.p_error
    assert 1e-4 < pe_model < 0.2  # 4-bit at tiny params is noisy (~1-2%)

    rng = np.random.default_rng(0)
    trials = 3000
    errors = 0
    xs = rng.integers(0, 16, trials)
    for x in xs:
        if circuit.simulate(int(x)) != int(x):
            errors += 1
    measured = errors / trials
    # agree within a factor ~3 (binomial noise + tail approximations)
    assert measured < max(3 * pe_model, 0.02), (measured, pe_model)
    if pe_model > 3e-3:
        assert measured > pe_model / 5, (measured, pe_model)


def test_simulation_tracks_leveled_noise_growth():
    @tfhe.compiler({"x": "encrypted"})
    def shallow(x):
        t = tfhe.LookupTable(list(range(8)))
        return t[x]

    circuit = shallow.compile(range(8), CFG, device="cpu")
    assert circuit.simulate(3) in range(8)


def test_simulation_multivariate_error_rate():
    """The multivariate (packed TLU) branch samples real PBS decision
    noise: an error rate within a factor of the model."""
    @tfhe.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return tfhe.multivariate(lambda a, b: (a + 2 * b) % 4)(x, y)

    circuit = f.compile([(i % 4, (i // 4) % 4) for i in range(16)], CFG,
                        device="cpu")
    pe_model = circuit.p_error
    rng = np.random.default_rng(1)
    trials = 2000
    errors = 0
    for _ in range(trials):
        a, b = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        if circuit.simulate(a, b) != (a + 2 * b) % 4:
            errors += 1
    measured = errors / trials
    assert measured < max(4 * pe_model, 0.03), (measured, pe_model)
    if pe_model > 5e-3:
        assert errors > 0, "multivariate simulation never errs " \
                           f"(model p_error {pe_model:.3g})"


def _plus_six(pkg):
    @pkg.compiler({"x": "encrypted"})
    def f(x):
        return x + 6
    return f


def test_detect_overflow_in_simulation():
    """Configuration.detect_overflow_in_simulation warns when a value
    escapes its encoding (silent wrap in real FHE)."""
    cfg = tfhe.Configuration(forced_parameters=TINY,
                             detect_overflow_in_simulation=True)
    circuit = _plus_six(tfhe).compile(range(2), cfg, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        circuit.simulate(3)                # out-of-inputset input: 9 > 7
    assert any("overflow" in str(w.message) for w in caught), \
        [str(w.message) for w in caught]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        circuit.simulate(1)
    assert not any("overflow" in str(w.message) for w in caught)


def test_simulation_noise_correlation():
    """x + x doubles the SAME noise sample (4x variance) while x + y sums
    independent samples (2x): the correlated circuit flips decisions
    measurably more often."""
    params = dataclasses.replace(TINY, glwe_std=0.03)
    cfg = tfhe.Configuration(forced_parameters=params)
    table = tfhe.LookupTable([0, 1, 2, 3, 0, 1, 2, 3])

    @tfhe.compiler({"x": "encrypted"})
    def correlated(x):
        return table[x + x]

    @tfhe.compiler({"x": "encrypted", "y": "encrypted"})
    def independent(x, y):
        return table[x + y]

    c1 = correlated.compile([0, 1, 2, 3], cfg, device="cpu")
    c2 = independent.compile([(i, j) for i in range(4) for j in range(4)],
                             cfg, device="cpu")
    rng = np.random.default_rng(11)
    n = 600
    flips1 = sum(
        int(tsimulate(c1.graph, c1.client_specs, 1, rng=rng)) != 2
        for _ in range(n))
    flips2 = sum(
        int(tsimulate(c2.graph, c2.client_specs, 1, 1, rng=rng)) != 2
        for _ in range(n))
    assert flips1 > flips2 + n * 0.05, (flips1, flips2)


# -- the port's draws against the JAX package's -----------------------------

def _univariate(pkg):
    table = pkg.LookupTable([(5 * v + 3) % 16 for v in range(16)])

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return table[x + y] + pkg.univariate(lambda v: v // 3)(x)

    return f, [(i % 8, (3 * i) % 8) for i in range(16)]


def _multivariate(pkg):
    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return pkg.multivariate(lambda a, b: (a * b + 1) % 8)(x, y) + x

    return f, [(i % 4, (i // 4) % 4) for i in range(16)]


def _multi_partition(pkg):
    """Two lookups of other widths: at the default configuration the
    planner gives each its partition and a frontier keyswitch between."""
    small = pkg.LookupTable([3, 1, 2, 0])
    big = pkg.LookupTable([(7 * i) % 4 for i in range(16)])

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return small[x] + big[y]

    return f, [(i % 4, (13 * i) % 16) for i in range(30)]


CASES = {"univariate": (_univariate, True),
         "multivariate": (_multivariate, True),
         "multi_partition": (_multi_partition, False)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_graph_matches_reference(name):
    """The same compiled function in both packages, simulated with the
    same seeded generator: equal values, sample for sample (noisy tiny
    parameters, so the draws decide some outputs)."""
    make, tiny = CASES[name]
    f_j, inputset = make(fhe)
    f_t, _ = make(tfhe)
    if tiny:
        jc = f_j.compile(inputset, fhe.Configuration(
            forced_parameters=dataclasses.replace(TEST_PARAMS_TINY,
                                                  glwe_std=2.0 ** -8)))
        tc = f_t.compile(inputset, tfhe.Configuration(
            forced_parameters=dataclasses.replace(TINY,
                                                  glwe_std=2.0 ** -8)),
            device="cpu")
    else:
        jc = f_j.compile(inputset)
        tc = f_t.compile(inputset, device="cpu")
        assert tc.client_specs.is_multi and tc.client_specs.conversions
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    x = np.array([v[0] for v in inputset])
    y = np.array([v[1] for v in inputset])
    for seed in range(3):
        want = jsimulate(jc.graph, jc.client_specs, x, y,
                         rng=np.random.default_rng(seed))
        got = tsimulate(tc.graph, tc.client_specs, x, y,
                        rng=np.random.default_rng(seed))
        assert np.array_equal(np.asarray(got), np.asarray(want))
    if tiny:
        # the noise decides: some outputs differ from the clear function
        clear = tc.graph.evaluate(x, y)[tc.graph.ordered_outputs[0]]
        outs = [tsimulate(tc.graph, tc.client_specs, x, y,
                          rng=np.random.default_rng(s)) for s in range(3)]
        assert any(not np.array_equal(o, clear) for o in outs)


def test_overflow_warning_matches_reference():
    jc = _plus_six(fhe).compile(range(2), fhe.Configuration(
        forced_parameters=TEST_PARAMS_TINY))
    tc = _plus_six(tfhe).compile(range(2), CFG, device="cpu")
    messages = []
    for sim, c in ((jsimulate, jc), (tsimulate, tc)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = sim(c.graph, c.client_specs, np.array([3, 1]),
                      rng=np.random.default_rng(0), detect_overflow=True)
        # node uids count the nodes each package made in this process
        messages.append([re.sub(r"%\d+", "%uid", str(w.message))
                         for w in caught])
        assert list(out) == [9, 7]
    assert messages[0] == messages[1] and len(messages[1]) == 1


@pytest.mark.parametrize("fields", [
    {"simulate_encrypt_run_decrypt": True},
    {"fhe_simulation": True, "fhe_execution": False}])
def test_encrypt_run_decrypt_routes_to_simulation(fields, monkeypatch):
    """Under these fields encrypt_run_decrypt is the simulator's, with no
    keys generated."""
    circuit = _plus_six(tfhe).compile(range(2), tfhe.Configuration(
        forced_parameters=TINY, **fields), device="cpu")
    assert circuit.encrypt_run_decrypt(1) == 7
    assert not circuit.keys.are_generated
