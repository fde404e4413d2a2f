"""``fhe.module`` in the port against the JAX package's, on CPU.

The module cases of ``tests/test_composition.py``,
``tests/test_compilation.py::test_module_composition`` and
``tests/test_api_surface.py::test_composition_policies`` /
``test_not_composable_module_runs_correctly`` compile in both packages at
``TEST_PARAMS_TINY``: per function the same graph, encoding widths and
``ClientSpecs`` under each composition policy, the same statistics, and
under one keyset from one seed the same output ciphertexts for one call
and for a two-call chain, bit for bit, on inputs the JAX package
encrypts.  The wide-TLU module (``TEST_PARAMS_TINY_WIDE``, WoP gadgets
(3, 6, 8, 4)) decrypts to the JAX package's output bits, with a fixed
seed in place of the JAX test's retries.  Refusals carry the JAX
package's messages.  The port runs with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.params import CryptoParams as TParams


def _cfg(pkg, params, **kw):
    if pkg is tfhe:
        params = TParams(**dataclasses.asdict(params))
    return pkg.Configuration(forced_parameters=params, **kw)


def _table(pkg, f, size=8):
    return pkg.LookupTable([f(v) for v in range(size)])


def _counter(pkg):
    """tests/test_composition.py:26: double, then increment."""
    @pkg.module()
    class Counter:
        @pkg.function({"x": "encrypted"})
        def double(x):
            return _table(pkg, lambda v: (2 * v) % 8)[x]

        @pkg.function({"x": "encrypted"})
        def increment(x):
            return _table(pkg, lambda v: (v + 1) % 8)[x]
    return Counter, {"double": list(range(8)), "increment": list(range(8))}


def _inc(pkg):
    """tests/test_composition.py:52: one function fed its own output."""
    @pkg.module()
    class Inc:
        @pkg.function({"x": "encrypted"})
        def inc(x):
            return _table(pkg, lambda v: (v + 1) % 8)[x]
    return Inc, {"inc": list(range(8))}


def _levelled(pkg):
    """tests/test_compilation.py:302: a levelled function and a lookup."""
    @pkg.module()
    class Counter:
        @pkg.function({"x": "encrypted"})
        def inc(x):
            return x + 1

        @pkg.function({"x": "encrypted"})
        def double(x):
            return _table(pkg, lambda v: (2 * v) % 16, 16)[x]
    return Counter, {"inc": list(range(15)), "double": list(range(8))}


def _composable(pkg):
    """tests/test_api_surface.py:74, the AllComposable half."""
    @pkg.module()
    class Composable:
        @pkg.function({"x": "encrypted"})
        def double(x):
            return (x * 2) % 8

        @pkg.function({"x": "encrypted"})
        def inc(x):
            return (x + 1) % 8
    return Composable, {"double": range(8), "inc": range(8)}


def _isolated(pkg):
    """tests/test_api_surface.py:98 and :185: NotComposable."""
    @pkg.module()
    class Isolated:
        composition = pkg.NotComposable()

        @pkg.function({"x": "encrypted"})
        def small(x):
            return x + 1

        @pkg.function({"x": "encrypted"})
        def big(x):
            return (x + 1) % 32
    return Isolated, {"small": range(2), "big": range(31)}


def _wired(pkg):
    """A Wired module: double's output feeds inc; small is on no wire."""
    @pkg.module()
    class WiredPair:
        composition = pkg.Wired([pkg.Wire(pkg.Output("double", 0),
                                          pkg.Input("inc", 0))])

        @pkg.function({"x": "encrypted"})
        def double(x):
            return _table(pkg, lambda v: (2 * v) % 8)[x]

        @pkg.function({"x": "encrypted"})
        def inc(x):
            return _table(pkg, lambda v: (v + 1) % 8)[x]

        @pkg.function({"x": "encrypted"})
        def small(x):
            return x + 1
    return WiredPair, {"double": range(8), "inc": range(8),
                       "small": range(2)}


# name: (build function, [(first function, argument, second function or
# None, the clear result)])
MODULES = {
    "counter": (_counter, [("double", 3, "increment", 7)]),
    "inc": (_inc, [("inc", 0, "inc", 2)]),
    "levelled": (_levelled, [("inc", 3, "double", 8)]),
    "composable": (_composable, [("double", 3, "inc", 7)]),
    "not_composable": (_isolated, [("small", 1, None, 2),
                                   ("big", 30, None, 31)]),
    "wired": (_wired, [("double", 2, "inc", 5), ("small", 1, None, 2)]),
}
_COMPILED: dict = {}


def _compiled(name):
    """(JAX module, port module), keyed from one seed."""
    if name not in _COMPILED:
        build = MODULES[name][0]
        jcls, inputsets = build(fhe)
        tcls, _ = build(tfhe)
        jm = jcls.compile(inputsets, _cfg(fhe, TEST_PARAMS_TINY))
        tm = tcls.compile(inputsets, _cfg(tfhe, TEST_PARAMS_TINY),
                          device="cpu")
        jm.keygen(seed=17)
        tm.keygen(seed=17)
        _COMPILED[name] = (jm, tm)
    return _COMPILED[name]


def _widths(fn):
    return [n.properties.get("encoding_width")
            for n in fn.graph.topological_order()]


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_compiles_as_reference(name):
    """Per function: the graph, every node's encoding width, the
    ClientSpecs, the statistics and the PBS count of the JAX package."""
    jm, tm = _compiled(name)
    assert tm.function_names == jm.function_names
    for f in jm.function_names:
        jf, tf = getattr(jm, f), getattr(tm, f)
        assert isinstance(tf, tfhe.Function)
        assert tf.graph.format() == jf.graph.format()
        assert _widths(tf) == _widths(jf)
        assert tf.client_specs.serialize() == jf.client_specs.serialize()
        assert tf.statistics == jf.statistics
        assert tf.programmable_bootstrap_count \
            == jf.programmable_bootstrap_count
    assert isinstance(tm, tfhe.Module)
    assert tm.keys is getattr(tm, tm.function_names[0]).client.keys


def test_policies_unify_as_reference():
    """AllComposable pins every value to the module width, NotComposable
    keeps per-value widths (small's narrower than big's), Wired unifies
    only the wired functions."""
    _, tm = _compiled("not_composable")
    w_small, w_big = (max(w for w in _widths(getattr(tm, f)) if w)
                      for f in ("small", "big"))
    assert w_small < w_big
    _, tw = _compiled("wired")
    p = tw.double.client_specs.message_bits
    assert set(_widths(tw.double)) - {None} == {p}
    assert set(_widths(tw.inc)) - {None} == {p}
    assert max(w for w in _widths(tw.small) if w) < p
    _, tc = _compiled("composable")
    assert all(set(_widths(getattr(tc, f))) - {None}
               == {tc.double.client_specs.message_bits}
               for f in tc.function_names)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_runs_as_reference(name):
    """One call and a two-call chain (the first output fed, as a
    ciphertext, to the second function): output ciphertexts equal to the
    JAX package's bit for bit under the same keys, and the clear result."""
    jm, tm = _compiled(name)
    for key in ("lwe_small", "glwe"):
        assert np.array_equal(getattr(tm.keys.secret, key),
                              getattr(jm.keys.secret, key))
    rng = np.random.default_rng(29)
    for first, arg, second, want in MODULES[name][1]:
        jf = getattr(jm, first)
        specs = jf.client_specs
        ct = jkg.encrypt_lwe_batch(
            rng, jm.keys.secret.lwe_big,
            jref.encode(np.asarray(arg), specs.input_width(0)),
            specs.params.glwe_std)
        jout = np.asarray(jf.run(ct))
        tout = getattr(tm, first).run(ct)
        assert tout.dtype == np.uint64 and np.array_equal(tout, jout)
        if second is not None:
            jout = np.asarray(getattr(jm, second).run(jout))
            tout = getattr(tm, second).run(tout)
            assert np.array_equal(tout, jout)
        last = getattr(tm, second or first)
        assert int(last.decrypt(tout)) == want
        assert int(last.decrypt(tout)) \
            == int(getattr(jm, second or first).decrypt(jout))


def test_loop_composes_five_times():
    """tests/test_composition.py:52's loop: inc on its own output five
    times, the JAX package's ciphertext at every call."""
    jm, tm = _compiled("inc")
    specs = jm.inc.client_specs
    ct = jkg.encrypt_lwe_batch(
        np.random.default_rng(31), jm.keys.secret.lwe_big,
        jref.encode(np.asarray(0), specs.input_width(0)),
        specs.params.glwe_std)
    jct = tct = ct
    for _ in range(5):
        jct, tct = np.asarray(jm.inc.run(jct)), tm.inc.run(tct)
        assert np.array_equal(tct, jct)
    assert int(tm.inc.decrypt(tct)) == 5


def test_encrypt_run_decrypt_and_not_ported():
    """The port's own client round trip through a module function, the
    levelled one (the client's encryption is unseeded, and a lookup's
    decision at TEST_PARAMS_TINY fails now and then: the lookups are held
    above on seeded ciphertexts); simulation equal to the JAX package's,
    and run_async, chained on its own future, equal to run."""
    jm, tm = _compiled("not_composable")
    assert int(tm.small.encrypt_run_decrypt(1)) == 2
    assert int(tm.small.simulate(1)) == int(jm.small.simulate(1)) == 2
    enc = tm.small.encrypt(1)
    fut = tm.small.run_async(enc)
    assert np.array_equal(fut.result(timeout=120), tm.small.run(enc))
    assert int(tm.small.decrypt(fut.result())) == 2


def _message(pkg, build, inputsets, params=TEST_PARAMS_TINY):
    kw = {"device": "cpu"} if pkg is tfhe else {}
    with pytest.raises((ValueError, TypeError)) as err:
        build(pkg).compile(inputsets, _cfg(pkg, params), **kw)
    return type(err.value), str(err.value)


def _amplifying(pkg):
    @pkg.module()
    class Amplifying:
        @pkg.function({"x": "encrypted"})
        def double(x):
            return x + x
    return Amplifying


def _empty(pkg):
    @pkg.module()
    class M:
        @pkg.function({"x": "encrypted"})
        def f(x):
            return x + 1
    return M


def _unknown_wire(pkg):
    @pkg.module()
    class Bad:
        composition = pkg.Wired([pkg.Wire(pkg.Output("nope", 0),
                                          pkg.Input("inc", 0))])

        @pkg.function({"x": "encrypted"})
        def inc(x):
            return x + 1
    return Bad


def _not_a_policy(pkg):
    @pkg.module()
    class Odd:
        composition = "all"

        @pkg.function({"x": "encrypted"})
        def inc(x):
            return x + 1
    return Odd


@pytest.mark.parametrize("build,inputsets", [
    (_amplifying, {"double": list(range(4))}),
    (_empty, {"f": []}),
    (_unknown_wire, {"inc": range(4)}),
    (_not_a_policy, {"inc": range(4)}),
    (_empty, {}),
], ids=["amplifying", "empty_inputset", "unknown_wire", "not_a_policy",
        "no_inputset"])
def test_refusals_match_reference(build, inputsets):
    want = _message(fhe, build, inputsets)
    assert _message(tfhe, build, inputsets) == want


def test_wide_tlu_module_matches_reference_bits():
    """tests/test_composition.py:122's module: a 9-bit table at
    TEST_PARAMS_TINY_WIDE with WoP gadgets (3, 6, 8, 4), one keyset and
    one PFPKSK from fixed seeds in both packages in place of the JAX
    test's retries: the same gadgets and specs, and the same decrypted
    bits as the JAX package on the same key form.  A WoP module runs on
    the untruncated BSK in the port, the rule of both packages'
    ``Circuit`` (a truncated key breaks narrow CRT lookups); the JAX
    package's module truncates, so it is held here on its own untruncated
    pack.  At these insecure parameters the WoP output is noisy in both
    packages (hence the JAX test's six tries): the bits must agree, right
    or wrong."""
    from concrete_tpu.core import wop as jwop
    table = [(3 * i + 1) % 8 for i in range(1 << 9)]

    def build(pkg):
        wide = pkg.LookupTable(table)

        @pkg.module()
        class Wide:
            @pkg.function({"x": "encrypted"})
            def lut(x):
                return wide[x]
        return Wide

    jm = build(fhe).compile({"lut": [0, 200, 511]}, _cfg(
        fhe, TEST_PARAMS_TINY_WIDE, forced_wop_parameters=(3, 6, 8, 4)))
    tm = build(tfhe).compile({"lut": [0, 200, 511]}, _cfg(
        tfhe, TEST_PARAMS_TINY_WIDE, forced_wop_parameters=(3, 6, 8, 4)),
        device="cpu")
    assert tm.lut.client_specs.serialize() == jm.lut.client_specs.serialize()
    jm.keygen(seed=43)
    tm.keygen(seed=43)
    wp = jm.lut.client_specs.wop_params()
    key = (wp.pfks_level, wp.pfks_base_log)
    jm.keys._pfpksk[key] = tm.keys._pfpksk[key] = jwop.pfpksk_gen(
        np.random.default_rng(53), jm.keys.secret, wp).pfpksk
    exact = jm.keys.evaluation_for(None) + (jm.keys.wop_evaluation(wp),)
    specs = jm.lut.client_specs
    rng = np.random.default_rng(47)
    for arg in (0, 200, 511):
        ct = jkg.encrypt_lwe_batch(
            rng, jm.keys.secret.lwe_big,
            jref.encode(np.asarray(arg), specs.input_width(0)),
            specs.params.glwe_std)
        out, = jm.lut.server.run(ct, evaluation_keys=exact)
        want = int(jm.lut.decrypt(np.asarray(out)))
        assert int(tm.lut.decrypt(tm.lut.run(ct))) == want
