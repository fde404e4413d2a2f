"""WoP-PBS through the port's front end, against the JAX package, on CPU.

At the cases of ``tests/test_wop_frontend.py``, ``tests/test_crt_tlu.py``
and ``tests/test_extensions.py``'s ``fhe.bits``: both packages compile the
same function to the same graph, ``ClientSpecs`` (``wop_gadgets``
included) and saved archive; the port's compile -> keygen ->
``Circuit.run`` on the CPU decrypts to the table itself (for ``crt_tlu``,
never the JAX package's output: its 4-bit blocks are a reference fault,
ROADMAP queue 3).  PrivateInformationRetrieval at 32 and 64 rows of 16
compiles to the JAX package's parameters, gadgets and archives.
"""

import dataclasses

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu import models as jm
from concrete_tpu.extensions import crt as jcrt
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch import models as tm
from concrete_tpu_torch.compilation.keys import Keys as TKeys
from concrete_tpu_torch.core import kernels_wop as kw
from concrete_tpu_torch.extensions import crt as tcrt
from concrete_tpu_torch.params import CryptoParams as TParams
from test_torch_server import _assert_same_archive

WOP_GADGETS = (3, 6, 8, 4)
MODULI = (3, 4, 5)


def _cfgs(params=TEST_PARAMS_TINY_WIDE, wop=WOP_GADGETS):
    kw_ = {} if params is None else {"forced_parameters": params}
    tkw = {} if params is None else {
        "forced_parameters": TParams(**dataclasses.asdict(params))}
    if wop is not None:
        kw_["forced_wop_parameters"] = tkw["forced_wop_parameters"] = wop
    return fhe.Configuration(**kw_), tfhe.Configuration(**tkw)


def _both(tmp_path, make, inputset, params=TEST_PARAMS_TINY_WIDE,
          wop=WOP_GADGETS):
    """Compile make(pkg) in both packages; assert the same graph, specs and
    archive; return (JAX circuit, port circuit)."""
    jcfg, tcfg = _cfgs(params, wop)
    jc = make(fhe).compile(inputset, jcfg)
    tc = make(tfhe).compile(inputset, tcfg, device="cpu")
    assert tc.graph.format() == jc.graph.format()
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jc.server.save(jpath)
    tc.server.save(tpath)
    _assert_same_archive(jpath, tpath)
    return jc, tc


def _retry(circuit, args, want, attempts=3):
    """TINY_WIDE is insecure and noisy: a lookup may misdecide."""
    for _ in range(attempts):
        got = circuit.encrypt_run_decrypt(*args)
        if np.array_equal(np.asarray(got), np.asarray(want)):
            break
    return got


def _table10(pkg):
    table = pkg.LookupTable([(3 * i + 1) % 32 for i in range(1 << 10)])

    @pkg.compiler({"x": "encrypted"})
    def f(x):
        return table[x]
    return f


def test_wide_tlu_10bit(tmp_path):
    """N = 256: two tree bits and eight rotations a lookup."""
    _, tc = _both(tmp_path, _table10, [0, 517, 1023])
    assert tc.client_specs.wop_gadgets == WOP_GADGETS
    ex = tc.server._executor
    assert [s.nb_bits for s in ex.wop_specs.values()] == [10]
    assert "wop_pbs(nb=10, out=5)" in tc.server.lowering_text()
    for m in (517, 1023):
        assert _retry(tc, (m,), (3 * m + 1) % 32) == (3 * m + 1) % 32


def test_wide_tlu_tensor_and_mixed_precision(tmp_path):
    def make(pkg):
        wide = pkg.LookupTable([i % 8 for i in range(1 << 10)])
        narrow = pkg.LookupTable([i * i % 8 for i in range(8)])

        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return narrow[wide[x]]
        return f

    jc, tc = _both(tmp_path, make, [np.array([0, 1000]),
                                    np.array([517, 3])])
    ex = tc.server._executor
    assert len(ex.wop_specs) == 1 and len(ex.tlu_specs) == 1
    assert tc.statistics == jc.statistics
    x = np.array([9, 1001])
    want = (x % 8) ** 2 % 8
    np.testing.assert_array_equal(_retry(tc, (x,), want), want)


def test_wide_tlu_signed_9bit(tmp_path):
    def make(pkg):
        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return pkg.univariate(lambda v: abs(v) % 16)(x)
        return f

    _, tc = _both(tmp_path, make, [-256, -1, 0, 255])
    assert _retry(tc, (-37,), 37 % 16) == 37 % 16


def test_wop_serialization_roundtrip(tmp_path):
    """Either package's archive loads in the port with its WoP lookups; the
    PFPKSK goes through the port's key files and evaluation keys."""
    def make(pkg):
        table = pkg.LookupTable([(i // 2) % 16 for i in range(1 << 9)])

        @pkg.compiler({"x": "encrypted"})
        def g(x):
            return table[x]
        return g

    _, tc = _both(tmp_path, make, [0, 511])
    loaded = tfhe.Server.load(str(tmp_path / "j.zip"), device="cpu")
    assert loaded.client_specs.wop_gadgets == WOP_GADGETS
    assert len(loaded._executor.wop_specs) == 1
    tc.keygen(seed=3)
    wp = tc.client_specs.wop_params()
    tc.keys.wop_evaluation(wp, device="cpu")
    path = str(tmp_path / "keys.npz")
    tc.keys.save(path)
    k2 = TKeys(tc.client_specs.params)
    k2.load(path)
    key = (wp.pfks_level, wp.pfks_base_log)
    np.testing.assert_array_equal(k2._pfpksk[key], tc.keys._pfpksk[key])
    # the archive-loaded server on the client's evaluation keys: the bits
    # of the compiled circuit's own server
    ev = tfhe.EvaluationKeys.deserialize(
        tc.client.evaluation_keys.serialize())
    ct = tc.encrypt(300)
    got = loaded.run(ct, evaluation_keys=ev)[0]
    np.testing.assert_array_equal(
        got, tc.server.run(ct, evaluation_keys=tc._evaluation_keys())[0])
    with pytest.raises(ValueError, match="PFPKSK"):
        loaded.run(ct, evaluation_keys=tc._evaluation_keys()[:2])


def test_wop_optimizer_path(tmp_path):
    """Without forced parameters both packages choose the same base
    parameters and gadgets for a 10-bit lookup."""
    _, tc = _both(tmp_path, _table10, [0, 517, 1023], params=None, wop=None)
    assert tc.client_specs.wop_gadgets is not None
    assert tc.client_specs.params.security_level == 128


def test_wop_fused_truncate_and_round(tmp_path):
    """Rounding fused into a 12-bit lookup extracts 10 bits."""
    def make_trunc(pkg):
        table = pkg.LookupTable([(3 * v + 1) % 16 for v in range(1 << 12)])

        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return table[pkg.truncate_bit_pattern(x, lsbs_to_remove=2)]
        return f

    def make_round(pkg):
        table = pkg.LookupTable([(v + 5) % 16 for v in range(1 << 12)])

        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return table[pkg.round_bit_pattern(x, lsbs_to_remove=2)]
        return f

    _, tt = _both(tmp_path, make_trunc, [0, 1111, 2502, (1 << 12) - 1])
    assert [s.nb_bits for s in tt.server._executor.wop_specs.values()] \
        == [10]
    want = (3 * ((2502 >> 2) << 2) + 1) % 16
    assert _retry(tt, (2502,), want) == want
    _, tr = _both(tmp_path, make_round, [0, 1113, 2503, (1 << 12) - 5])
    want = ((((1113 + 2) >> 2) << 2) + 5) % 16
    assert _retry(tr, (1113,), want) == want


def test_wide_output_and_clear_tlu_compile(tmp_path):
    def make_wide(pkg):
        table = pkg.LookupTable(list(range(1 << 6)))

        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return table[pkg.truncate_bit_pattern(x, lsbs_to_remove=7)
                         >> 7] * 3
        return f

    inputset = [int(v) for v in
                np.random.default_rng(1).integers(0, 1 << 13, 40)] \
        + [0, (1 << 13) - 1]
    _both(tmp_path, make_wide, inputset, params=None, wop=None)

    def make_clear(pkg):
        wide = pkg.LookupTable([i % 8 for i in range(1 << 10)])

        @pkg.compiler({"x": "encrypted", "c": "clear"})
        def g(x, c):
            return wide[x] + pkg.univariate(lambda v: int(v) + 1)(c)
        return g

    _, tc = _both(tmp_path, make_clear, [(0, 1), (1023, 3), (517, 2)])
    ex = tc.server._executor
    clear = [n for n in tc.graph.topological_order()
             if n.name == "univariate" and not n.output.is_encrypted]
    assert clear and all(n.uid not in ex.tlu_specs
                         and n.uid not in ex.wop_specs for n in clear)


def test_wide_multi_table(tmp_path):
    """Per-element tables on a 10-bit input: each element its own row."""
    rows = np.stack([[(3 * i + 1) % 16 for i in range(1 << 10)],
                     [(i // 2) % 16 for i in range(1 << 10)]])

    def make(pkg):
        tables = pkg.LookupTable(rows)

        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return tables[x]
        return f

    _, tc = _both(tmp_path, make, [np.array([0, 1023]), np.array([517, 2]),
                                   np.array([800, 31])])
    x = np.array([517, 40])
    want = np.array([(3 * 517 + 1) % 16, (40 // 2) % 16])
    np.testing.assert_array_equal(_retry(tc, (x,), want), want)


def test_frontend_crt_tlu(tmp_path):
    """fhe.crt_tlu over moduli (3, 4, 5): decryptions held to the table
    itself."""
    table = np.array([(7 * v + 1) % 60 for v in range(60)], dtype=np.int64)

    def make(pkg):
        crt = jcrt if pkg is fhe else tcrt

        @pkg.compiler({"r0": "encrypted", "r1": "encrypted",
                       "r2": "encrypted"})
        def f(r0, r1, r2):
            return crt.crt_tlu((r0, r1, r2), table, MODULI)
        return f

    inputset = [tuple(jcrt.crt_encode_clear(v, MODULI))
                for v in range(0, 60, 7)] + [(2, 3, 4)]
    jc, tc = _both(tmp_path, make, inputset)
    assert tc.wop_pbs_count == jc.wop_pbs_count
    for x in (13, 59):
        r = tcrt.crt_encode_clear(x, MODULI)
        got = _retry(tc, r, tcrt.crt_encode_clear(int(table[x]), MODULI))
        assert tcrt.crt_decode_clear(got, MODULI) == int(table[x]), (x, got)


def test_crt_tlu_runs_in_chunks_within_its_memory_check(monkeypatch):
    """A crt_tlu over two elements at a chunk budget of one element: the
    memory check models one chunk of the circuit bootstrap (refused one
    byte below it), and the run makes one circuit bootstrap and one
    transform of its GGSWs a chunk, for all three output residues, with
    the bits of the unchunked run."""
    table = np.array([(7 * v + 1) % 60 for v in range(60)], dtype=np.int64)

    @tfhe.compiler({"r0": "encrypted", "r1": "encrypted", "r2": "encrypted"})
    def f(r0, r1, r2):
        return tcrt.crt_tlu((r0, r1, r2), table, MODULI)

    def residues(*vs):
        return tuple(np.array([v % m for v in vs]) for m in MODULI)

    inputset = [residues(v, 59 - v) for v in range(0, 60, 7)] \
        + [residues(59, 58)]
    tc = f.compile(inputset, _cfgs()[1], device="cpu")
    wp = tc.client_specs.wop_params()
    monkeypatch.setenv("CONCRETE_TPU_WOP_CHUNK_MB", "0")
    one = kw.wop_memory_estimate(wp, 7, 1)
    with pytest.raises(MemoryError, match=str(one["total"])):
        tc.server.check_wop_memory(free_bytes=one["total"] - 1)
    assert tc.server.check_wop_memory(free_bytes=one["total"]) == [one] * 3
    cbs, packs = [], []
    for name, log in (("circuit_bootstrap_batch", cbs),
                      ("ggsw_spectra", packs)):
        def counted(x, *args, _fn=getattr(kw, name), _log=log):
            _log.append(x.shape[0])
            return _fn(x, *args)
        monkeypatch.setattr(kw, name, counted)
    tc.keygen(seed=5)
    cts = tc.encrypt(*residues(13, 59))
    chunked = tc.run(*cts)
    assert cbs == [1, 1] and packs == [1, 1]
    monkeypatch.delenv("CONCRETE_TPU_WOP_CHUNK_MB")
    whole = tc.run(*cts)
    assert cbs == [1, 1, 2] and packs == [1, 1, 2]
    for a, b in zip(chunked, whole):
        np.testing.assert_array_equal(a, b)


def test_bits_extraction(tmp_path):
    """fhe.bits at the TINY parameters (a banded key, no WoP gadgets): the
    lsb cascade of sign PBS."""
    def make(pkg):
        @pkg.compiler({"x": "encrypted"})
        def f(x):
            return pkg.bits(x)[0] + 2 * pkg.bits(x)[2]
        return f

    jc, tc = _both(tmp_path, make, range(8), params=TEST_PARAMS_TINY,
                   wop=None)
    assert tc.client_specs.wop_gadgets is None
    assert tc.statistics == jc.statistics
    for x in (5, 6):
        want = (x & 1) + 2 * ((x >> 2) & 1)
        assert _retry(tc, (x,), want) == want


@pytest.mark.parametrize("rows", [32, 64])
def test_pir_compiles_to_reference(tmp_path, rows):
    """PIR over rows x 16 at the default Configuration(): a WoP row fetch
    (nb = 9 at 32 rows, 11 at 64), the JAX package's parameters, gadgets
    and archive, and the memory model's PFPKSK of 32,776 and 65,544 GLWE
    rows."""
    db = np.random.default_rng(rows).integers(0, 16, (rows, 16))
    jc = jm.PrivateInformationRetrieval(db).compile()
    tc = tm.PrivateInformationRetrieval(db).compile(device="cpu")
    assert tc.client_specs.serialize() == jc.client_specs.serialize()
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jc.server.save(jpath)
    tc.server.save(tpath)
    _assert_same_archive(jpath, tpath)
    p = tc.client_specs.params
    nb = {32: 9, 64: 11}[rows]
    assert [s.nb_bits for s in tc.server._executor.wop_specs.values()] \
        == [nb]
    wp = tc.client_specs.wop_params()
    kp1 = p.glwe_dimension + 1
    assert kp1 * (p.n_big + 1) * wp.pfks_level == {32: 32776, 64: 65544}[rows]
    est = kw.wop_memory_estimate(wp, nb, 1)
    assert est["pfpksk_u64"] == kp1 * (p.n_big + 1) * wp.pfks_level \
        * kp1 * p.polynomial_size * 8
