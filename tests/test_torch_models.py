"""The port's model circuits against the JAX package's, on CPU.

Each of the five models the port serves compiles in both packages at
``TEST_PARAMS_TINY_WIDE`` at the sizes of ``tests/test_models.py``: equal
``ClientSpecs`` and saved archives (multivariate nodes materialized with
their packed layout), and under one secret key and the same JAX-encrypted
inputs the port's output ciphertexts equal the JAX package's bit for bit
and decrypt to the model's clear function.  The archives load in both
packages.  The port runs with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu import models as jm
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch import models as tm
from concrete_tpu_torch.params import CryptoParams as TParams
from test_torch_server import _assert_same_archive

JCFG = fhe.Configuration(forced_parameters=TEST_PARAMS_TINY_WIDE)
TCFG = tfhe.Configuration(forced_parameters=TParams(
    **dataclasses.asdict(TEST_PARAMS_TINY_WIDE)))
PIR_DB = np.array([[1, 2, 0], [3, 0, 1], [0, 1, 2], [2, 3, 3]])


def _gol(pkg_models, cfg, **kw):
    return pkg_models.GameOfLife(3, 3).compile(cfg, **kw)


def _lev(pkg_models, cfg, **kw):
    return pkg_models.LevenshteinDistance(2, 2, alphabet_bits=1).compile(
        cfg, **kw)


def _kvdb(pkg_models, cfg, **kw):
    return pkg_models.StaticKeyValueDatabase([1, 3, 5], [10, 4, 7]).compile(
        cfg, **kw)


def _hamming(via):
    def make(pkg_models, cfg, **kw):
        return pkg_models.HammingDistance(n_words=4, word_bits=2).compile(
            cfg, via=via, **kw)
    return make


def _pir(pkg_models, cfg, **kw):
    return pkg_models.PrivateInformationRetrieval(PIR_DB).compile(cfg, **kw)


_HD = jm.HammingDistance(n_words=4, word_bits=2)
# (compile, arguments, the model's clear function)
MODELS = {
    "game_of_life": (_gol, [(np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0]]),)],
                     lambda g: jm.GameOfLife(3, 3).step_clear(g).reshape(-1)),
    "levenshtein": (_lev, [(np.array([0, 1]), np.array([1, 1])),
                           (np.array([1, 0]), np.array([0, 0]))],
                    lambda a, b: jm.LevenshteinDistance.distance_clear(
                        list(a), list(b))),
    "kvdb": (_kvdb, [(3,), (5,), (2,)],
             jm.StaticKeyValueDatabase([1, 3, 5], [10, 4, 7]).query_clear),
    "hamming_packed": (_hamming("packed"),
                       [(np.array([0, 3, 1, 2]), np.array([3, 3, 0, 2]))],
                       _HD.distance_clear),
    "hamming_xor": (_hamming("xor"),
                    [(np.array([1, 2, 3, 0]), np.array([2, 2, 1, 3]))],
                    _HD.distance_clear),
    "pir": (_pir, [(0,), (3,)],
            jm.PrivateInformationRetrieval(PIR_DB).query_clear),
}
_COMPILED: dict = {}


def _compiled(name):
    """(JAX circuit, port circuit), keys from one seed."""
    if name not in _COMPILED:
        make = MODELS[name][0]
        jc, tc = make(jm, JCFG), make(tm, TCFG, device="cpu")
        jc.keygen(seed=5)
        tc.keygen(seed=5)
        _COMPILED[name] = (jc, tc)
    return _COMPILED[name]


#: the models this file runs; GameOfLife and Levenshtein, the slowest on
#: the CPU, run the same checks from test_torch_models_gol.py and
#: test_torch_models_lev.py, so that a run with one file per worker spreads
#: them over three workers
NAMES = ["kvdb", "hamming_packed", "hamming_xor", "pir"]


def check_compile_and_archive(tmp_path, name):
    jc, tc = _compiled(name)
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    assert not tc.client_specs.is_multi
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jc.server.save(jpath)
    tc.server.save(tpath)
    _assert_same_archive(jpath, tpath)
    # each package loads the other's archive
    fhe.Server.load(tpath)
    tfhe.Server.load(jpath, device="cpu")


def check_run(tmp_path, name):
    """Identical output ciphertexts, also from the port's Server.load of
    the JAX package's archive, and the model's clear answer."""
    jc, tc = _compiled(name)
    path = str(tmp_path / "j.zip")
    jc.server.save(path)
    loaded = tfhe.Server.load(path, device="cpu")
    specs = jc.client_specs
    _, cases, clear = MODELS[name]
    rng = np.random.default_rng(11)
    for args in cases:
        cts = [jkg.encrypt_lwe_batch(
            rng, jc.keys.secret.lwe_big,
            jref.encode(np.asarray(v), specs.input_width(pos)),
            specs.params.glwe_std) for pos, v in enumerate(args)]
        want = [np.asarray(w) for w in jc.server.run(
            *cts, evaluation_keys=jc.keys.evaluation_keys)]
        got = tc.server.run(*cts, evaluation_keys=tc.keys.evaluation_keys)
        again = loaded.run(*cts, evaluation_keys=tc.keys.evaluation_keys)
        for g, a, w in zip(got, again, want):
            assert g.dtype == np.uint64
            assert np.array_equal(g, w) and np.array_equal(a, w)
        dec = tc.decrypt(*got)
        assert np.array_equal(np.asarray(dec).reshape(-1),
                              np.asarray(clear(*args)).reshape(-1)), \
            (name, args, dec)


@pytest.mark.parametrize("name", NAMES)
def test_model_compile_and_archive_match_reference(tmp_path, name):
    check_compile_and_archive(tmp_path, name)


@pytest.mark.parametrize("name", NAMES)
def test_model_run_matches_reference(tmp_path, name):
    check_run(tmp_path, name)


@pytest.mark.parametrize("name", ["game_of_life", "levenshtein"])
def test_save_materializes_multivariate_nodes(tmp_path, name):
    """At the default Configuration(), the port's Server.save of a compiled
    GameOfLife(3, 3) or LevenshteinDistance(2, 2, 1) writes the JAX
    package's archive: every multivariate node as an explicit table with
    its packed layout.  Each package loads the other's archive into the
    same executor tables."""
    import io
    import json
    import zipfile
    make = MODELS[name][0]
    jc, tc = make(jm, fhe.Configuration()), make(tm, tfhe.Configuration(),
                                                  device="cpu")
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jc.server.save(jpath)
    tc.server.save(tpath)
    _assert_same_archive(jpath, tpath)
    with zipfile.ZipFile(tpath) as z:
        nodes = json.loads(z.read("graph.json"))["nodes"]
        arrays = np.load(io.BytesIO(z.read("graph_arrays.npz")))
        multi = [n for n in nodes if n.get("name") == "multivariate"]
        assert multi and all(
            {"table", "mins", "widths", "offsets"} <= set(n["kwargs"])
            for n in multi)
        assert len(arrays.files) >= len(multi)
    jl, tl = fhe.Server.load(tpath), tfhe.Server.load(jpath, device="cpu")
    jspecs = jl._executor.multivariate_specs
    tspecs = tl._executor.multivariate_specs
    assert len(tspecs) == len(jspecs) == len(multi)
    by_table = sorted(s.lut_poly.tobytes() for s in jspecs.values())
    assert by_table == sorted(s.lut_poly.tobytes() for s in tspecs.values())
