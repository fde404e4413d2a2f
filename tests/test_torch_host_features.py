"""The port's host features against the JAX package's, on CPU: seeded
compression, the insecure key cache and debug artifacts.

- Compression: ``encrypt_seeded``, ``decompress``, ``keygen_seeded`` and
  ``SeededServerKeys.expand`` give the JAX package's arrays bit for bit
  from the same seeds; a compiled circuit serves a compressed input
  (``tests/test_compilation.py::test_seeded_compression``'s size bound),
  to the JAX package's output ciphertext.
- The key cache: ``Keys`` and ``MultiKeys`` write their file, reload it
  and reuse it; a file either package writes loads in the other with
  identical keys; a keyset from an injected GLWE key is never cached, its
  PFPKSK neither; a cached keyset keeps its PFPKSK; ``Circuit`` takes the
  cache from its ``Configuration``.
- Debug artifacts: ``tests/test_compilation.py::test_debug_artifacts``'s
  function writes the JAX package's files, byte for byte.
"""

import dataclasses
import os

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.compilation.keys import Keys as JKeys
from concrete_tpu.compilation.keys import MultiKeys as JMultiKeys
from concrete_tpu.core import compression as jcz
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.core.wop import WopParams as JWopParams
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation.keys import Keys as TKeys
from concrete_tpu_torch.compilation.keys import MultiKeys as TMultiKeys
from concrete_tpu_torch.core import compression as tcz
from concrete_tpu_torch.core import keygen as tkg
from concrete_tpu_torch.core.wop import WopParams as TWopParams
from concrete_tpu_torch.params import CryptoParams as TParams

SEED_BYTES = bytes(range(32))


def _tp(p):
    return TParams(**dataclasses.asdict(p))


def _cfg(pkg, **kw):
    params = TEST_PARAMS_TINY if pkg is fhe else _tp(TEST_PARAMS_TINY)
    return pkg.Configuration(forced_parameters=params, **kw)


def _increment(pkg, config):
    """tests/test_compilation.py:361's circuit."""
    @pkg.compiler({"x": "encrypted"})
    def f(x):
        return x + 1
    kw = {"device": "cpu"} if pkg is tfhe else {}
    return f.compile(range(6), config, **kw)


# -- seeded compression -------------------------------------------------------

def test_encrypt_seeded_and_decompress_match_reference():
    sk = jref.sample_binary_key(np.random.default_rng(3), (300,))
    m = (np.arange(12, dtype=np.uint64) << np.uint64(58)).reshape(3, 4)
    want = jcz.encrypt_seeded(np.random.default_rng(5), sk, m, 2.0 ** -40,
                              seed=SEED_BYTES)
    got = tcz.encrypt_seeded(np.random.default_rng(5), sk, m, 2.0 ** -40,
                             seed=SEED_BYTES)
    assert isinstance(got, tcz.SeededLweCiphertext)
    assert got.seed == want.seed and got.n == want.n == 300
    assert got.bodies.dtype == np.uint64
    assert np.array_equal(got.bodies, want.bodies)
    assert got.size_bytes == want.size_bytes
    full = tcz.decompress(got)
    assert full.shape == (3, 4, 301)
    assert np.array_equal(full, jcz.decompress(want))
    # the expanded ciphertexts decrypt to the messages
    phase = jref.lwe_decrypt(sk, full)
    assert np.array_equal((phase + np.uint64(1 << 57)) >> np.uint64(58),
                          np.arange(12, dtype=np.uint64).reshape(3, 4))


@pytest.mark.parametrize("params", [TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE],
                         ids=["tiny", "tiny_wide"])
def test_keygen_seeded_and_expand_match_reference(params):
    jsk, jseeded = jkg.keygen_seeded(np.random.default_rng(7), params,
                                     seed=SEED_BYTES)
    tsk, tseeded = tkg.keygen_seeded(np.random.default_rng(7), _tp(params),
                                     seed=SEED_BYTES)
    assert np.array_equal(tsk.lwe_small, jsk.lwe_small)
    assert np.array_equal(tsk.glwe, jsk.glwe)
    for name in ("bsk_bodies", "ksk_bodies"):
        assert np.array_equal(getattr(tseeded, name), getattr(jseeded, name))
    assert tseeded.size_bytes == jseeded.size_bytes
    texp, jexp = tseeded.expand(), jseeded.expand()
    assert np.array_equal(texp.bsk, jexp.bsk)
    assert np.array_equal(texp.ksk, jexp.ksk)
    assert texp.bsk.shape == (params.n_small, params.pbs_level,
                              params.glwe_dimension + 1,
                              params.glwe_dimension + 1,
                              params.polynomial_size)


def test_compressed_input_served_as_reference():
    """A seeded input: under the JAX test's size bound, decompressed on the
    host before the upload, served to the JAX package's output
    ciphertext; Circuit.encrypt seeds under compress_input_ciphertexts."""
    jc = _increment(fhe, _cfg(fhe))
    tc = _increment(tfhe, _cfg(tfhe))
    jc.keygen(seed=11)
    tc.keygen(seed=11)
    enc = tc.client.encrypt(4, compress=True)
    assert isinstance(enc, tcz.SeededLweCiphertext)
    n = tc.client_specs.params.n_big
    assert enc.size_bytes < (n + 1) * 8 / 4
    out = tc.run(enc)
    assert tc.decrypt(out) == 5
    assert np.array_equal(out, tc.run(tcz.decompress(enc)))
    # the JAX package serves the port's seeded input to the same bits
    jenc = jcz.SeededLweCiphertext(seed=enc.seed, bodies=enc.bodies, n=enc.n)
    assert np.array_equal(out, np.asarray(jc.run(jenc)))
    seeded = _increment(tfhe, _cfg(tfhe, compress_input_ciphertexts=True,
                                   compress_evaluation_keys=True))
    seeded.keygen(seed=11)
    enc = seeded.encrypt(2)
    assert isinstance(enc, tcz.SeededLweCiphertext)
    assert seeded.decrypt(seeded.run(enc)) == 3
    assert not isinstance(tc.encrypt(2), tcz.SeededLweCiphertext)


# -- the insecure key cache ---------------------------------------------------

def _same_keys(a, b):
    assert np.array_equal(a.secret.lwe_small, b.secret.lwe_small)
    assert np.array_equal(a.secret.glwe, b.secret.glwe)
    assert (a._server is None) == (b._server is None)
    if a._server is not None:
        assert np.array_equal(a.server.bsk, b.server.bsk)
        assert np.array_equal(a.server.ksk, b.server.ksk)


@pytest.mark.parametrize("secret_only", [False, True])
def test_keys_cache_writes_reloads_and_reuses(tmp_path, secret_only):
    d = str(tmp_path)
    first = TKeys(_tp(TEST_PARAMS_TINY), cache_directory=d)
    first.generate(seed=5, secret_only=secret_only, device="cpu")
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("keys_")
    path = os.path.join(d, files[0])
    assert path == first._cache_path(5, secret_only)
    stamp = os.path.getmtime(path)
    again = TKeys(_tp(TEST_PARAMS_TINY), cache_directory=d)
    again.generate(seed=5, secret_only=secret_only, device="cpu")
    assert os.listdir(d) == files and os.path.getmtime(path) == stamp
    _same_keys(again, first)
    # the JAX package names the same keyset's file the same way
    assert os.path.basename(path) == os.path.basename(JKeys(
        TEST_PARAMS_TINY, cache_directory=d)._cache_path(5, secret_only))
    other = TKeys(_tp(TEST_PARAMS_TINY), cache_directory=d)
    other.generate(seed=6, secret_only=secret_only, device="cpu")
    assert len(os.listdir(d)) == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_keys_cache_file_loads_in_the_other_package(tmp_path, writer):
    d = str(tmp_path)
    jkeys = JKeys(TEST_PARAMS_TINY, cache_directory=d)
    tkeys = TKeys(_tp(TEST_PARAMS_TINY), cache_directory=d)
    first, second = (jkeys, tkeys) if writer == "jax" else (tkeys, jkeys)
    first.generate(seed=9, **_on_cpu(first))
    files = sorted(os.listdir(d))
    stamp = os.path.getmtime(os.path.join(d, files[0]))
    second.generate(seed=9, **_on_cpu(second))
    assert sorted(os.listdir(d)) == files
    assert os.path.getmtime(os.path.join(d, files[0])) == stamp
    _same_keys(tkeys, jkeys)


def _on_cpu(keys) -> dict:
    """The port's keygen on the CPU (its default device is the card)."""
    return {"device": "cpu"} if isinstance(keys, (TKeys, TMultiKeys)) \
        else {}


def _multi(pkg, d):
    conv = {(2, 3): (2, 12)}
    if pkg is fhe:
        return JMultiKeys({2: TEST_PARAMS_TINY, 3: TEST_PARAMS_TINY_WIDE},
                          conv, cache_directory=d, pbs_widths={2})
    return TMultiKeys({2: _tp(TEST_PARAMS_TINY),
                       3: _tp(TEST_PARAMS_TINY_WIDE)}, conv,
                      cache_directory=d, pbs_widths={2})


def _same_multi(a, b):
    for w in (2, 3):
        _same_keys(a.keys_for(w), b.keys_for(w))
    assert set(a._fks) == set(b._fks) == {(2, 3)}
    assert np.array_equal(a._fks[(2, 3)], b._fks[(2, 3)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multikeys_cache_writes_reloads_and_crosses(tmp_path, writer):
    """One file for every partition (a secret-only one among them) and
    conversion key; reloaded by the same package and by the other."""
    d = str(tmp_path)
    first = _multi(fhe if writer == "jax" else tfhe, d)
    first.generate(seed=13, **_on_cpu(first))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].startswith("multikeys_")
    stamp = os.path.getmtime(os.path.join(d, files[0]))
    for pkg in (fhe, tfhe):
        again = _multi(pkg, d)
        again.generate(seed=13, **_on_cpu(again))
        _same_multi(again, first)
        assert again.keys_for(3)._server is None
    assert os.listdir(d) == files
    assert os.path.getmtime(os.path.join(d, files[0])) == stamp


def _wop_params(pkg):
    base = TEST_PARAMS_TINY_WIDE if pkg is fhe else _tp(TEST_PARAMS_TINY_WIDE)
    return (JWopParams if pkg is fhe else TWopParams)(
        base=base, cbs_level=3, cbs_base_log=6, pfks_level=8, pfks_base_log=4)


def test_foreign_keyset_never_cached(tmp_path):
    """tests/test_api_surface.py's test_wop_cache_never_stores_foreign_
    keysets, in the port: a keyset from an injected GLWE key, and its
    PFPKSK, never reach the cache."""
    d = str(tmp_path)
    normal = TKeys(_tp(TEST_PARAMS_TINY_WIDE), cache_directory=d)
    normal.generate(seed=None, device="cpu")
    files = {f: os.path.getmtime(os.path.join(d, f)) for f in os.listdir(d)}
    assert files
    shared = np.random.default_rng(0).integers(
        0, 2, (TEST_PARAMS_TINY_WIDE.glwe_dimension,
               TEST_PARAMS_TINY_WIDE.polynomial_size)).astype(np.uint64)
    foreign = TKeys(_tp(TEST_PARAMS_TINY_WIDE), cache_directory=d)
    foreign.generate(seed=None, glwe_key=shared, device="cpu")
    assert np.array_equal(foreign.secret.glwe, shared)
    foreign.wop_keys(_wop_params(tfhe), device="cpu")
    assert {f: os.path.getmtime(os.path.join(d, f))
            for f in os.listdir(d)} == files


def test_cached_keyset_keeps_its_pfpksk(tmp_path):
    """The PFPKSK refresh rule: a generated PFPKSK is written into the
    keyset's cache file, and a reload takes it instead of a new one."""
    d = str(tmp_path)
    keys = TKeys(_tp(TEST_PARAMS_TINY_WIDE), cache_directory=d)
    keys.generate(seed=21, device="cpu")
    pfpksk = keys.wop_keys(_wop_params(tfhe), device="cpu")
    again = TKeys(_tp(TEST_PARAMS_TINY_WIDE), cache_directory=d)
    again.generate(seed=21, device="cpu")
    assert np.array_equal(again._pfpksk[(8, 4)], pfpksk)
    # and the JAX package reads it from the same file
    jkeys = JKeys(TEST_PARAMS_TINY_WIDE, cache_directory=d)
    jkeys.generate(seed=21)
    assert np.array_equal(jkeys._pfpksk[(8, 4)], pfpksk)


def test_circuit_takes_the_cache_from_its_configuration(tmp_path):
    d = str(tmp_path)
    config = _cfg(tfhe, use_insecure_key_cache=True,
                  insecure_key_cache_location=d)
    first = _increment(tfhe, config)
    first.keygen(seed=3)
    assert len(os.listdir(d)) == 1
    second = _increment(tfhe, config)
    assert second.keys.cache_directory == d
    second.keygen(seed=3)
    _same_keys(second.keys, first.keys)
    assert second.decrypt(second.run(first.encrypt(4))) == 5
    # without use_insecure_key_cache the location is not read
    assert _increment(tfhe, _cfg(
        tfhe, insecure_key_cache_location=d)).keys.cache_directory is None


# -- debug artifacts ----------------------------------------------------------

def _artifacts(pkg, d):
    @pkg.compiler({"x": "encrypted"})
    def f(x):
        return pkg.LookupTable([1, 0, 3, 2])[x]
    artifacts = pkg.DebugArtifacts(d)
    kw = {"device": "cpu"} if pkg is tfhe else {}
    f.compile(range(4), _cfg(pkg), artifacts=artifacts, **kw)
    return {name: open(os.path.join(d, name)).read()
            for name in sorted(os.listdir(d))}


def test_debug_artifacts_match_reference(tmp_path):
    want = _artifacts(fhe, str(tmp_path / "jax"))
    got = _artifacts(tfhe, str(tmp_path / "port"))
    assert list(got) == list(want)
    assert {"bounds.txt", "graph.f.txt", "parameters.txt",
            "statistics.txt"} <= set(got)
    assert got == want
    assert tfhe.FunctionDebugArtifacts is tfhe.DebugArtifacts
    assert tfhe.ModuleDebugArtifacts is tfhe.DebugArtifacts
