"""A multi-partition circuit with a WoP partition, against the JAX
package, on CPU.

``ts[x] + tb[y]``: a 2-bit table on x beside a 9-bit one on y, compiled
mono at TINY_WIDE with WoP gadgets, then given a partition per encoding
width as ``tests/test_torch_multi.py``'s ``_kinds_multi`` gives them (x in
2, y in 9, the lookups' outputs and their sum in 3) with the gadgets on
partition 9 alone: the 9-bit lookup is a WoP-PBS (N=256 serves 7 bits
natively) whose output crosses the 9 -> 3 frontier through a conversion
keyswitch, the 2-bit one a native PBS crossing 2 -> 3.  Under one seed
the keys (every partition's arrays, the conversion keys, and the WoP
partition's PFPKSK from a seeded generator), the ciphertexts and the
output ciphertexts equal the JAX package's, and decrypt to the clear
function.  The port runs with ``device="cpu"``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import concrete_tpu as fhe
from concrete_tpu.compilation.circuit import Circuit as JCircuit
from concrete_tpu.core import wop as jwop
from concrete_tpu.params import TEST_PARAMS_TINY_WIDE
from concrete_tpu.utils.csprng import SecureGenerator as JSecureGenerator

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation.circuit import Circuit as TCircuit
from concrete_tpu_torch.compilation.specs import ClientSpecs as TSpecs
from concrete_tpu_torch.core import keygen as tkg
from concrete_tpu_torch.core import refimpl as tref
from concrete_tpu_torch.core import wop as twop
from concrete_tpu_torch.utils.csprng import SecureGenerator
from test_torch_multi import _encrypt, _kinds_multi, _tparams
from test_torch_server import _assert_same_archive

TS = [3, 1, 2, 0]
TB = [(5 * i + 2) % 4 for i in range(1 << 9)]
GADGETS = (3, 6, 8, 4)
REQUESTS = ((3, 300),)


def _circuit(pkg, **kw):
    ts, tb = pkg.LookupTable(TS), pkg.LookupTable(TB)

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return ts[x] + tb[y]

    params = TEST_PARAMS_TINY_WIDE if pkg is fhe \
        else _tparams(TEST_PARAMS_TINY_WIDE)
    inputset = [(i % 4, (37 * i) % (1 << 9)) for i in range(20)] + [(3, 511)]
    return f.compile(inputset, pkg.Configuration(
        forced_parameters=params, forced_wop_parameters=GADGETS), **kw)


def _port_encrypt(circuit, args, seed: int) -> list:
    """``_encrypt`` through the port's client keys and keygen module."""
    rng = np.random.default_rng(seed)
    specs, out = circuit.client_specs, []
    for pos, arg in enumerate(args):
        sk, std = circuit.client._secret_for(specs.input_partition(pos))
        out.append(tkg.encrypt_lwe_batch(
            rng, sk, tref.encode(np.asarray(arg, dtype=np.int64),
                                 specs.input_width(pos)), std))
    return out


@pytest.fixture(scope="module")
def wopmulti():
    """Both packages' circuits on the multi specs, keys from seed 5 in
    each, the JAX keyset's PFPKSK (os.urandom in both packages) handed to
    the port, and REQUESTS run by both on the same ciphertexts."""
    jmono, tmono = _circuit(fhe), _circuit(tfhe, device="cpu")
    jspecs, crossing = _kinds_multi(jmono, TEST_PARAMS_TINY_WIDE)
    jspecs = dataclasses.replace(jspecs, partition_wop_gadgets={9: GADGETS})
    tspecs = TSpecs.deserialize(jspecs.serialize())
    jm = JCircuit(jmono.graph, jspecs)
    tm = TCircuit(tmono.graph, tspecs, device="cpu")
    jm.keygen(seed=5)
    tm.keygen(seed=5)
    jkeys = jm._evaluation_keys()
    tm.keys.keys_for(9)._pfpksk = dict(jm.keys.keys_for(9)._pfpksk)
    runs = []
    for i, args in enumerate(REQUESTS):
        enc = _encrypt(jm, args, seed=i)
        jout = jm.server.run(*enc, evaluation_keys=jkeys)
        tout = tm.run(*enc)
        runs.append((args, enc, jout, tout if isinstance(tout, tuple)
                     else (tout,)))
    return SimpleNamespace(jm=jm, tm=tm, crossing=crossing, runs=runs,
                           jmono=jmono, tmono=tmono)


def test_partitions_gadgets_and_archive_match_reference(wopmulti, tmp_path):
    """x, y and the outputs in three partitions, the 9-bit lookup the only
    WoP one and a frontier after each lookup; the executor's gadgets per
    partition, the secret-only partition and the archive equal the JAX
    package's."""
    jm, tm = wopmulti.jm, wopmulti.tm
    specs = tm.client_specs
    assert sorted(specs.partitions) == [2, 3, 9]
    assert specs.conversions == {(2, 3): (2, 10), (9, 3): (2, 10)}
    assert wopmulti.crossing == {"tlu"}
    ex, jex = tm.server._executor, jm.server._executor
    assert [s.nb_bits for s in ex.wop_specs.values()] == \
        [s.nb_bits for s in jex.wop_specs.values()] == [9]
    for w in specs.partitions:
        twp, jwp = ex.wop_params_for(w), jex.wop_params_for(w)
        assert (twp is None) == (jwp is None) == (w != 9)
        if twp is not None:
            assert dataclasses.asdict(twp) == dataclasses.asdict(jwp)
    assert tm._pbs_widths() == jm._pbs_widths() == {2, 9}
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    jm.server.save(jpath)
    tm.server.save(tpath)
    _assert_same_archive(jpath, tpath)


def test_keys_from_one_seed_match_reference(wopmulti):
    """Every partition's arrays (partition 3 secret-only) and the
    conversion keys from seed 5 equal the JAX package's, the port's BSKs
    computed through its device path; the WoP partition's PFPKSK from a
    seeded generator equals the JAX package's pfpksk_gen."""
    jk, tk = wopmulti.jm.keys, wopmulti.tm.keys
    for w in (2, 3, 9):
        jd = jk.keys_for(w)._to_npz_dict()
        td = tk.keys_for(w)._to_npz_dict()
        assert list(td) == list(jd)
        for name in jd:
            np.testing.assert_array_equal(td[name], jd[name])
    assert "bsk" not in tk.keys_for(3)._to_npz_dict()
    for key in tk.conversions:
        np.testing.assert_array_equal(tk._fks[key], jk._fks[key])
    jwp = wopmulti.jm.client_specs.wop_params(9)
    twp = wopmulti.tm.client_specs.wop_params(9)
    sk = tk.secret_for(9)
    want = jwop.pfpksk_gen(JSecureGenerator(31), jk.secret_for(9),
                           jwp).pfpksk
    got = twop.pfpksk_gen_device(SecureGenerator(31), sk, twp, "cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_requests_bit_equal_to_reference(wopmulti):
    """The same ciphertexts (the port's encryption from the same stream
    equal to the JAX client's) through both circuits: output ciphertexts
    equal bit for bit, decrypting in both clients to ts[x] + tb[y]."""
    jm, tm = wopmulti.jm, wopmulti.tm
    for i, (args, enc, jout, tout) in enumerate(wopmulti.runs):
        for a, b in zip(_port_encrypt(tm, args, seed=i), enc):
            np.testing.assert_array_equal(a, b)
        assert len(tout) == 1
        assert len(jout) == 1
        np.testing.assert_array_equal(tout[0], np.asarray(jout[0]))
        x, y = args
        assert tm.decrypt(*tout) == jm.decrypt(*jout) == TS[x] + TB[y]
