"""The port's ``Sha1`` against the JAX package's, on CPU.

``Sha1`` compiles in both packages at the default ``Configuration()`` and
at ``Configuration(p_error=1e-8)`` (``tests/test_models.py``'s digest
configuration) to the same ``CryptoParams`` and, per function, the same
graph, encoding widths, ``ClientSpecs`` and statistics.  At the forced
tiny parameters of ``tests/test_models.py`` (``TEST_PARAMS_TINY_WIDE``),
under one keyset from one seed, one ``add2`` call (a carry chain of 63
lookups) and one ``choose`` call (one multivariate lookup over 32 bits)
give the JAX package's output ciphertexts bit for bit.  The host side of a
digest (padding, message schedule, word split) is the JAX package's; the
port's ``digest`` in its default simulate mode gives hashlib's digest at
``p_error=1e-8``.  The port runs with ``device="cpu"``.
"""

import dataclasses
import hashlib
import subprocess
import sys

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.models import Sha1 as JSha1
from concrete_tpu.models import sha1 as jsha1
from concrete_tpu.params import TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.models import Sha1 as TSha1
from concrete_tpu_torch.models import sha1 as tsha1
from concrete_tpu_torch.params import CryptoParams as TParams

FUNCTIONS = ["add2", "choose", "majority", "parity", "rotate30",
             "round_add"]
_COMPILED: dict = {}


def _compiled(name):
    """(JAX module, port module) of Sha1 at one configuration."""
    if name not in _COMPILED:
        if name == "tiny":
            jcfg = fhe.Configuration(forced_parameters=TEST_PARAMS_TINY_WIDE)
            tcfg = tfhe.Configuration(forced_parameters=TParams(
                **dataclasses.asdict(TEST_PARAMS_TINY_WIDE)))
        else:
            kw = {"p_error": 1e-8} if name == "p_error_1e-8" else {}
            jcfg, tcfg = fhe.Configuration(**kw), tfhe.Configuration(**kw)
        _COMPILED[name] = (JSha1().compile(jcfg),
                           TSha1().compile(tcfg, device="cpu"))
    return _COMPILED[name]


@pytest.mark.parametrize("name", ["default", "p_error_1e-8"])
def test_sha1_compiles_as_reference(name):
    jm, tm = _compiled(name)
    assert tm.function_names == jm.function_names == FUNCTIONS
    params = {getattr(tm, f).client_specs.params for f in FUNCTIONS}
    assert len(params) == 1            # one keyset for the six functions
    assert dataclasses.asdict(params.pop()) \
        == dataclasses.asdict(jm.add2.client_specs.params)
    for f in FUNCTIONS:
        jf, tf = getattr(jm, f), getattr(tm, f)
        assert tf.graph.format() == jf.graph.format()
        assert [n.properties.get("encoding_width")
                for n in tf.graph.topological_order()] \
            == [n.properties.get("encoding_width")
                for n in jf.graph.topological_order()]
        assert tf.client_specs.serialize() == jf.client_specs.serialize()
        assert tf.statistics == jf.statistics
        assert tf.graph.max_norm2() == jf.graph.max_norm2()
    # the shapes the card serves: 63-lookup carry chains, 32-bit lookups
    assert [getattr(tm, f).programmable_bootstrap_count
            for f in FUNCTIONS] == [63, 32, 32, 32, 0, 63]


def _encrypted(jm, fn, words, seed):
    specs = getattr(jm, fn).client_specs
    rng = np.random.default_rng(seed)
    return [jkg.encrypt_lwe_batch(
        rng, jm.keys.secret.lwe_big,
        jref.encode(jsha1.split32(w), specs.input_width(pos)),
        specs.params.glwe_std) for pos, w in enumerate(words)]


@pytest.mark.parametrize("fn,words,clear", [
    ("add2", (0xDEADBEEF, 0x12345678),
     lambda x, y: (x + y) % 2 ** 32),
    ("choose", (0xDEADBEEF, 0x12345678, 0xF0F0F0F0),
     lambda x, y, z: z ^ (x & (y ^ z))),
])
def test_sha1_function_runs_as_reference(fn, words, clear):
    """One call at TEST_PARAMS_TINY_WIDE on the JAX package's ciphertexts:
    the same output ciphertexts bit for bit, decrypting to the clear
    function's word."""
    jm, tm = _compiled("tiny")
    jm.keygen(seed=3)
    tm.keygen(seed=3)
    cts = _encrypted(jm, fn, words, seed=1)
    want = np.asarray(getattr(jm, fn).run(*cts))
    got = getattr(tm, fn).run(*cts)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    assert tsha1.unsplit32(getattr(tm, fn).decrypt(got)) == clear(*words)


@pytest.mark.parametrize("message", [b"", b"abc", b"x" * 77])
def test_sha1_host_side_matches_reference(message):
    """Padding and the message schedule (the clear control flow) are the
    JAX package's, and give hashlib's digest in the clear."""
    assert TSha1._pad(message) == JSha1._pad(message)
    padded = TSha1._pad(message)
    for start in range(0, len(padded), 64):
        chunk = padded[start:start + 64]
        for a, b in zip(TSha1._schedule(chunk), JSha1._schedule(chunk)):
            assert np.array_equal(a, b)
    assert tsha1.unsplit32(tsha1.split32(0xC3D2E1F0)) == 0xC3D2E1F0
    assert np.array_equal(tsha1._rotl(tsha1.split32(0x80000001), 5),
                          tsha1.split32(0x30))
    assert len(hashlib.sha1(message).digest()) == 20


def test_sha1_modes():
    sha = TSha1()
    with pytest.raises(RuntimeError, match="compile"):
        sha.digest(b"abc", mode="run")
    # the default mode, simulate: the digest configuration of
    # tests/test_models.py (77 bytes: two chunks)
    _, sha.module = _compiled("p_error_1e-8")
    for message in (b"abc", b"x" * 77):
        assert sha.hexdigest(message) == hashlib.sha1(message).hexdigest()
    with pytest.raises(ValueError, match="unknown mode"):
        sha.digest(b"abc", mode="fast")


def test_sha1_imports_no_jax():
    code = ("import sys; from concrete_tpu_torch.models import Sha1; "
            "assert 'jax' not in sys.modules "
            "and 'concrete_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)
