"""The port's radix big integers against the JAX package's, on CPU.

The cases of ``tests/test_bigint.py`` on ``concrete_tpu_torch`` (6-bit
integers as three 2-bit limbs at ``TEST_PARAMS_TINY``: add, mul, lt and
eq decrypted right, with the same retries for the tiny parameters'
failures), then each op's compiled circuit in both packages under one
keyset from one seed, on the same ciphertexts: the same graph and
``ClientSpecs``, and output ciphertexts equal bit for bit.  The port runs
with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.extensions import bigint as jbi
from concrete_tpu.params import TEST_PARAMS_TINY

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.extensions import bigint as bi
from concrete_tpu_torch.params import CryptoParams as TParams

W = 2       # limb bits
NL = 3      # limbs -> 6-bit integers
OPS = ("radix_add", "radix_mul", "radix_lt", "radix_eq")
_COMPILED: dict = {}


def _compile(pkg, op):
    """`op` of `pkg`'s bigint over two NL-limb inputs, at TINY; cached."""
    if (pkg, op) not in _COMPILED:
        mod = jbi if pkg is fhe else bi

        @pkg.compiler({"a": "encrypted", "b": "encrypted"})
        def f(a, b):
            a_l = [a[i] for i in range(NL)]
            b_l = [b[i] for i in range(NL)]
            return getattr(mod, op)(a_l, b_l, W)

        rng = np.random.default_rng(0)
        inputset = [(rng.integers(0, 4, (NL,)), rng.integers(0, 4, (NL,)))
                    for _ in range(30)]
        if pkg is fhe:
            _COMPILED[(pkg, op)] = f.compile(inputset, fhe.Configuration(
                forced_parameters=TEST_PARAMS_TINY))
        else:
            _COMPILED[(pkg, op)] = f.compile(inputset, tfhe.Configuration(
                forced_parameters=TParams(
                    **dataclasses.asdict(TEST_PARAMS_TINY))), device="cpu")
    return _COMPILED[(pkg, op)]


def _enc(v):
    return np.array(bi.radix_decompose_clear(v, W, NL))


def _run(circuit, x, y):
    return circuit.encrypt_run_decrypt(_enc(x), _enc(y))


def test_radix_add():
    circuit = _compile(tfhe, "radix_add")
    mod = 1 << (W * NL)
    for x, y in ((5, 7), (33, 42), (63, 63)):
        for _ in range(4):
            got = _run(circuit, x, y)
            if bi.radix_recompose_clear(got, W) == (x + y) % mod:
                break
        else:
            raise AssertionError((x, y, got))


def test_radix_mul():
    circuit = _compile(tfhe, "radix_mul")
    mod = 1 << (W * NL)
    for x, y in ((5, 7), (9, 6)):
        for _ in range(5):
            got = _run(circuit, x, y)
            if bi.radix_recompose_clear(got, W) == (x * y) % mod:
                break
        else:
            raise AssertionError((x, y, got))


def test_radix_compare():
    circ_lt = _compile(tfhe, "radix_lt")
    circ_eq = _compile(tfhe, "radix_eq")
    for x, y in ((5, 7), (7, 5), (33, 33)):
        for _ in range(4):
            got = circ_lt.encrypt_run_decrypt(_enc(x), _enc(y))
            if int(got) == int(x < y):
                break
        else:
            raise AssertionError(("lt", x, y, got))
        for _ in range(4):
            got = circ_eq.encrypt_run_decrypt(_enc(x), _enc(y))
            if int(got) == int(x == y):
                break
        else:
            raise AssertionError(("eq", x, y, got))


def test_clear_radix_helpers_match_reference():
    for v in (0, 1, 37, 63):
        limbs = bi.radix_decompose_clear(v, W, NL)
        assert limbs == jbi.radix_decompose_clear(v, W, NL)
        assert bi.radix_recompose_clear(limbs, W) == v


@pytest.mark.parametrize("op", OPS)
def test_op_bits_match_reference(op):
    """One keyset from one seed and the same ciphertexts in both
    packages: the port's output ciphertexts are the JAX package's."""
    jc, tc = _compile(fhe, op), _compile(tfhe, op)
    assert tc.graph.format() == jc.graph.format()
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    # the port's circuit may hold an unseeded keyset from the cases above
    jc.keygen(force=True, seed=11)
    tc.keygen(force=True, seed=11)
    specs = jc.client_specs
    rng = np.random.default_rng(12)
    cts = [jkg.encrypt_lwe_batch(
        rng, jc.keys.secret.lwe_big,
        jref.encode(_enc(v), specs.input_width(pos)),
        specs.params.glwe_std) for pos, v in enumerate((45, 27))]
    want = jc.run(*cts)
    got = tc.run(*cts)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint64
        assert np.array_equal(g, np.asarray(w))
