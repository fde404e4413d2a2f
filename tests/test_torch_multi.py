"""Multi-partition circuits in the port against the JAX package, on CPU.

The cases of ``tests/test_multi.py`` that serving a multi-partition
circuit covers (simulation is ``tests/test_torch_simulation.py``'s):
``MultiKeys`` from one seed equal to the JAX package's array by array,
secret-only partitions included, and its npz blob byte for byte; a JAX
blob loaded in the port; the conversion keys split on the device
bit-equal to the host split; ``_mixed_circuit("multi")`` of ``tests/test_multi.py`` at the
default configuration (compiled once a module, one request through the
JAX package) with output ciphertexts bit-equal under the same keys and
ciphertexts; a circuit with a frontier at every lookup kind but the WoP
ones (partitions assigned by encoding width at TINY_WIDE) bit-equal too;
the multi archive, ``complexity``, the statistics with the frontier
keyswitch and ``p_error`` equal to the JAX package's; the norm2 cut's
synthetic ids through ``Server.load``; and mono circuits kept off every
multi branch.  The port runs with ``device="cpu"``.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import concrete_tpu as fhe
from concrete_tpu.compilation.circuit import Circuit as JCircuit
from concrete_tpu.compilation.evaluation_keys import \
    EvaluationKeys as JEvaluationKeys
from concrete_tpu.compilation.keys import MultiKeys as JMultiKeys
from concrete_tpu.compilation.server import Server as JServer
from concrete_tpu.compilation.widths import (TLU_OPS, partition_of,
                                             tlu_input_partition)
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import limbs as jlb
from concrete_tpu.core import refimpl as jref
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation.circuit import Circuit as TCircuit
from concrete_tpu_torch.compilation.evaluation_keys import \
    EvaluationKeys as TEvaluationKeys
from concrete_tpu_torch.compilation.keys import Keys as TKeys
from concrete_tpu_torch.compilation.keys import MultiKeys as TMultiKeys
from concrete_tpu_torch.compilation.server import Server as TServer
from concrete_tpu_torch.compilation.specs import ClientSpecs as TSpecs
from concrete_tpu_torch.core import limbs as tlb
from concrete_tpu_torch.params import CryptoParams as TParams
from test_torch_server import _assert_same_archive

BIG = 4
TABLE_SMALL = [3, 1, 2, 0]
TABLE_BIG = [(i * 7) % 4 for i in range(1 << BIG)]


def _tparams(p):
    return TParams(**dataclasses.asdict(p))


def _mixed_circuit(pkg, **kw):
    """tests/test_multi.py's: x (2-bit) and y (BIG-bit) each feed their
    own TLU; the outputs join.  Multi at the default configuration."""
    table_small = pkg.LookupTable(TABLE_SMALL)
    table_big = pkg.LookupTable(TABLE_BIG)

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return table_small[x] + table_big[y]

    inputset = [(int(i % 4), int((i * 13) % (1 << BIG)))
                for i in range(30)]
    return f.compile(inputset, **kw)


def _encrypt(circuit, args, seed: int) -> list:
    """The JAX client's encryption of `args` (each input under its
    partition's big key at its GLWE noise), from a seeded stream."""
    rng = np.random.default_rng(seed)
    specs, out = circuit.client_specs, []
    for pos, arg in enumerate(args):
        if not specs.inputs[pos].is_encrypted:
            out.append(np.asarray(arg))
            continue
        sk, std = circuit.client._secret_for(specs.input_partition(pos))
        out.append(jkg.encrypt_lwe_batch(
            rng, sk, jref.encode(np.asarray(arg, dtype=np.int64),
                                 specs.input_width(pos)), std))
    return out


def _port_keys(jkeys, specs) -> TMultiKeys:
    return TMultiKeys.deserialize_with(jkeys.serialize(), specs.partitions,
                                       specs.conversions or {})


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def mixed():
    """_mixed_circuit("multi") compiled by both packages, the JAX keys from
    seed 7 carried into the port through their blob, and one request
    (x=2, y=11) run by both on the same ciphertexts."""
    jc = _mixed_circuit(fhe, parameter_selection_strategy="multi")
    tc = _mixed_circuit(tfhe, device="cpu")
    jc.keygen(seed=7)
    tc.client.keys = _port_keys(jc.keys, tc.client_specs)
    enc = _encrypt(jc, (2, 11), seed=5)
    jout = jc.server.run(*enc, evaluation_keys=jc._evaluation_keys())
    tout = _as_tuple(tc.run(*enc))
    return SimpleNamespace(jc=jc, tc=tc, enc=enc, jout=jout, tout=tout)


def test_mixed_circuit_compiles_to_the_reference_partitions(mixed):
    jspecs, tspecs = mixed.jc.client_specs, mixed.tc.client_specs
    assert tspecs.is_multi and tspecs.serialize() == jspecs.serialize()
    assert BIG in tspecs.partitions and tspecs.conversions
    assert isinstance(mixed.tc.keys, TMultiKeys)
    assert mixed.tc._pbs_widths() == mixed.jc._pbs_widths()
    ex = mixed.tc.server._executor
    assert ex.partitions == tspecs.partitions
    assert ex.conversions == tspecs.conversions


def test_mixed_request_bit_equal_to_reference(mixed):
    """Circuit.run in the port on the JAX client's ciphertexts and the JAX
    keys: the JAX package's output ciphertexts bit for bit, which decrypt
    (in both clients) to the clear function."""
    assert len(mixed.tout) == len(mixed.jout)
    for t, j in zip(mixed.tout, mixed.jout):
        assert t.dtype == np.uint64
        np.testing.assert_array_equal(t, np.asarray(j))
    want = TABLE_SMALL[2] + TABLE_BIG[11]
    assert mixed.tc.decrypt(*mixed.tout) == mixed.jc.decrypt(
        *mixed.jout) == want


def test_client_keys_follow_the_partitions(mixed):
    """Inputs encrypt under their input partition's big key at its
    glwe_std, outputs decrypt under their output partition's, as in the
    JAX client; a port encryption decrypts in the JAX client."""
    jc, tc = mixed.jc, mixed.tc
    specs = tc.client_specs
    pids = [(specs.input_partition(i), specs.params_for_width(
        specs.input_partition(i)).glwe_std) for i in range(2)]
    assert len({p for p, _ in pids}) == 2      # x and y in two partitions
    for pos in range(2):
        sk, std = tc.client._secret_for(specs.input_partition(pos))
        jsk, jstd = jc.client._secret_for(specs.input_partition(pos))
        np.testing.assert_array_equal(sk, jsk)
        assert std == jstd
    osk, _ = tc.client._secret_for(specs.output_partition(0))
    np.testing.assert_array_equal(
        osk, jc.client._secret_for(specs.output_partition(0))[0])
    x, y = tc.encrypt(3, 5)
    for pos, (ct, v) in enumerate(((x, 3), (y, 5))):
        sk, _ = jc.client._secret_for(specs.input_partition(pos))
        assert jref.decode(jref.lwe_decrypt(sk, ct),
                           specs.input_width(pos)) == v


def test_multikeys_from_a_seed_match_reference():
    """MultiKeys.generate in both packages from one seed: every array of
    every partition equal (partition 6 secret-only), the conversion keys
    equal, the npz blob byte for byte; the packed conversion key sits at
    its frontier's gadget."""
    tiny, wide = TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE
    parts = {3: tiny, 5: wide, 6: wide}
    conv = {(3, 5): (3, 8), (5, 3): (2, 10), (5, 6): (2, 10)}
    jk = JMultiKeys(parts, conv, pbs_widths={3, 5})
    tk = TMultiKeys({w: _tparams(p) for w, p in parts.items()}, conv,
                    pbs_widths={3, 5})
    jk.generate(seed=11)
    tk.generate(seed=11, device="cpu")
    assert tk.are_generated
    for w in parts:
        jd, td = jk.keys_for(w)._to_npz_dict(), tk.keys_for(w)._to_npz_dict()
        assert list(td) == list(jd)
        for name in jd:
            np.testing.assert_array_equal(td[name], jd[name])
    assert "bsk" not in tk.keys_for(6)._to_npz_dict()
    with pytest.raises(RuntimeError, match="secret-only"):
        tk.keys_for(6).server
    for key in conv:
        np.testing.assert_array_equal(tk._fks[key], jk._fks[key])
    assert tk.serialize() == jk.serialize()
    ksk = tk.conversion_key(5, 3, device="cpu")
    assert (ksk.base_log, ksk.levels) == (10, 2)
    assert ksk.planes.shape == (wide.n_big, 2, tiny.n_big + 1, 8)


def test_reference_blob_loads_and_conversion_keys_split_on_device(mixed):
    """The JAX package's MultiKeys blob loads in the port with the same
    secrets, the same conversion keys and the same bytes back; each
    conversion key's limb planes, split on the device, equal the host
    split and the JAX package's packed key, at the frontier's gadget."""
    jk, specs = mixed.jc.keys, mixed.tc.client_specs
    blob = jk.serialize()
    tk = TMultiKeys.deserialize_with(blob, specs.partitions,
                                     specs.conversions)
    assert tk.are_generated and tk.serialize() == blob
    for w in specs.partitions:
        for field in ("lwe_small", "glwe"):
            np.testing.assert_array_equal(
                getattr(tk.secret_for(w), field),
                getattr(jk.secret_for(w), field))
    for (s, d), (lvl, base) in specs.conversions.items():
        np.testing.assert_array_equal(tk._fks[(s, d)], jk._fks[(s, d)])
        packed = tk.conversion_key(s, d, device="cpu")
        jpacked = jk.conversion_key(s, d)
        assert (packed.base_log, packed.levels) == (base, lvl) == \
            (jpacked.base_log, jpacked.levels)
        assert packed.planes.dtype == torch.int8
        np.testing.assert_array_equal(packed.planes.numpy(),
                                      tlb.u64_to_balanced_i8(jk._fks[(s, d)]))
        np.testing.assert_array_equal(packed.planes.numpy(),
                                      np.asarray(jpacked.planes))
        np.testing.assert_array_equal(
            packed.planes.numpy(), jlb.u64_to_balanced_i8(jk._fks[(s, d)]))


def test_multi_archive_matches_reference_and_round_trips(mixed, tmp_path):
    """The port's multi archive is the JAX package's; loaded in either
    package it keeps the partitions, conversions and lookup tables."""
    jpath, tpath = str(tmp_path / "j.zip"), str(tmp_path / "t.zip")
    mixed.jc.server.save(jpath)
    mixed.tc.server.save(tpath)
    _assert_same_archive(jpath, tpath)
    loaded = TServer.load(tpath, device="cpu")
    assert loaded.client_specs.serialize() == \
        mixed.tc.client_specs.serialize()
    ex, ex0 = loaded._executor, mixed.tc.server._executor
    assert ex.partitions == ex0.partitions
    assert ex.conversions == ex0.conversions
    assert sorted(loaded._lut_polys) == sorted(mixed.tc.server._lut_polys)
    for a, b in zip(loaded._lut_polys.values(),
                    mixed.tc.server._lut_polys.values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # a loaded graph lists its edges node by node: saved again, it is the
    # JAX package's archive loaded and saved again
    jloaded = JServer.load(tpath)
    assert set(jloaded._executor.partitions) == \
        set(mixed.tc.client_specs.partitions)
    again, jagain = str(tmp_path / "again.zip"), str(tmp_path / "jagain.zip")
    loaded.save(again)
    jloaded.save(jagain)
    _assert_same_archive(jagain, again)


def test_complexity_statistics_and_p_error_match_reference(mixed):
    """complexity costs each lookup in its partition plus the conversion
    keyswitch; the statistics count the frontier keyswitch; p_error and
    the per-width PBS counts equal the JAX package's."""
    jc, tc = mixed.jc, mixed.tc
    assert tc.complexity == jc.complexity
    assert tc.statistics == jc.statistics
    assert tc.statistics["key_switch_count"] == \
        tc.statistics["programmable_bootstrap_count"] + 1
    assert tc.programmable_bootstrap_count_per_bit_width == \
        jc.programmable_bootstrap_count_per_bit_width
    assert tc.p_error == jc.p_error
    assert tc.global_p_error == jc.global_p_error


def _kinds_circuit(pkg, **kw):
    """A frontier at every native lookup kind: tlu, univariate,
    multivariate, dynamic_tlu and extract_bits each map their input class
    into another one (compiled mono at TINY_WIDE; _kinds_multi gives every
    encoding width its own partition)."""
    sq = pkg.LookupTable([(v * v) % 16 for v in range(8)])

    @pkg.compiler({"t": "clear", "x": "encrypted", "y": "encrypted",
                   "z": "encrypted"})
    def f(t, x, y, z):
        return (sq[x], pkg.univariate(lambda v: (3 * v) % 16)(y),
                pkg.multivariate(lambda u, v: (u + 2 * v) % 4)(y, z),
                t[x], pkg.bits(x)[1])

    inputset = [(np.arange(8) * 3, i % 8, (3 * i) % 8, (5 * i) % 4)
                for i in range(16)]
    cfg = pkg.Configuration(forced_parameters=TEST_PARAMS_TINY_WIDE
                            if pkg is fhe else _tparams(TEST_PARAMS_TINY_WIDE))
    return f.compile(inputset, cfg, **kw)


def _kinds_multi(circuit, params) -> tuple:
    """(specs, crossings): the mono circuit's specs with a partition per
    encoding width, all at `params`, and a conversion key (2 levels of
    base 2^10) at each lookup's frontier."""
    g, p = circuit.graph, circuit.client_specs.message_bits
    widths = {partition_of(n, p) for n in g.topological_order()
              if n.output.is_encrypted}
    conv, crossing = {}, set()
    for n in g.topological_order():
        if n.name in TLU_OPS and n.output.is_encrypted:
            src, dst = tlu_input_partition(g, n, p), partition_of(n, p)
            if src != dst:
                conv[(src, dst)] = (2, 10)
                crossing.add(n.name)
    return dataclasses.replace(
        circuit.client_specs, partitions={w: params for w in widths},
        conversions=conv,
        input_partitions=[partition_of(n, p) for n in g.ordered_inputs],
        output_partitions=[partition_of(n, p) for n in g.ordered_outputs]
    ), crossing


def test_a_frontier_at_every_lookup_kind_matches_reference():
    """Every native lookup kind crossing a frontier, in both packages on the
    same keys and ciphertexts: bit-equal outputs, right decryptions, the
    frontier keyswitches counted alike."""
    jmono = _kinds_circuit(fhe)
    tmono = _kinds_circuit(tfhe, device="cpu")
    jspecs, crossing = _kinds_multi(jmono, TEST_PARAMS_TINY_WIDE)
    assert crossing == {"tlu", "univariate", "multivariate", "dynamic_tlu",
                        "extract_bits"}
    tspecs = TSpecs.deserialize(jspecs.serialize())
    jm = JCircuit(jmono.graph, jspecs)
    tm = TCircuit(tmono.graph, tspecs, device="cpu")
    jm.keygen(seed=3)
    tm.client.keys = _port_keys(jm.keys, tspecs)
    table = np.arange(8) * 3
    for args, seed in (((table, 5, 7, 3), 1), ((table, 2, 1, 0), 2)):
        enc = _encrypt(jm, args, seed)
        jout = jm.server.run(*enc, evaluation_keys=jm._evaluation_keys())
        tout = tm.run(*enc)
        for t, j in zip(tout, jout):
            np.testing.assert_array_equal(t, np.asarray(j))
        _, x, y, z = args
        assert tuple(int(v) for v in tm.decrypt(*tout)) == (
            x * x % 16, 3 * y % 16, (y + 2 * z) % 4, table[x], (x >> 1) & 1)
    assert tm.statistics == jm.statistics
    assert tm.complexity == jm.complexity


def _norm2_circuit(pkg, **kw):
    """tests/test_multi.py's: two 6-bit classes of different norm2 that the
    PRECISION_AND_NORM2 cut splits into a width and a synthetic id."""
    table = pkg.LookupTable([(3 * i) % 16 for i in range(1 << 6)])

    @pkg.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return table[x * 15] + table[table[y]]

    inputset = [(int(i % 4), int((i * 31) % 64)) for i in range(40)]
    return f.compile(
        inputset,
        parameter_selection_strategy=pkg.ParameterSelectionStrategy.MULTI,
        multi_parameter_strategy=(
            pkg.MultiParameterStrategy.PRECISION_AND_NORM2), **kw)


def test_norm2_cut_ids_survive_server_load(tmp_path):
    from concrete_tpu_torch.compilation.widths import part_width
    circ = _norm2_circuit(tfhe, device="cpu")
    specs = circ.client_specs
    six = [w for w in specs.partitions if part_width(w) == 6]
    assert len(six) == 2 and max(six) > 255      # a synthetic id
    assert TSpecs.deserialize(specs.serialize()).input_partitions == \
        specs.input_partitions
    path = str(tmp_path / "srv.zip")
    circ.server.save(path)
    srv = TServer.load(path, device="cpu")
    ex, ex0 = srv._executor, circ.server._executor
    assert set(ex.partitions) == set(specs.partitions)
    assert sorted(ex.part_of(n) for n in srv.graph.topological_order()
                  if n.output.is_encrypted) == \
        sorted(ex0.part_of(n) for n in circ.graph.topological_order()
               if n.output.is_encrypted)
    assert {ex.params_for_width(w) for w in six} == \
        {specs.partitions[w] for w in six}
    assert isinstance(circ.keys, TMultiKeys)


def test_wop_params_per_partition_match_reference(mixed):
    """ClientSpecs.wop_params(width) of a partition's WoP gadgets, as the
    JAX package builds them (the widest partition's by default)."""
    from concrete_tpu.compilation.specs import ClientSpecs as JSpecs
    gadgets = {3: (3, 6, 8, 4), BIG: (2, 9, 3, 10)}
    jspecs = dataclasses.replace(mixed.jc.client_specs,
                                 partition_wop_gadgets=gadgets)
    tspecs = TSpecs.deserialize(jspecs.serialize())
    assert JSpecs.deserialize(tspecs.serialize()).partition_wop_gadgets \
        == gadgets
    for w in (None, 3, BIG):
        assert dataclasses.asdict(tspecs.wop_params(w)) == \
            dataclasses.asdict(jspecs.wop_params(w))
    assert tspecs.wop_params(99) is None


def test_multi_refusals(mixed, tmp_path):
    """EvaluationKeys refuses a MultiKeys in the JAX package's words; the
    multi server takes only the 4-tuple, on its device; the insecure key
    cache (item 6) is taken."""
    tc = mixed.tc
    with pytest.raises(NotImplementedError) as tmsg:
        TEvaluationKeys.from_keys(tc.keys)
    with pytest.raises(NotImplementedError) as jmsg:
        JEvaluationKeys.from_keys(mixed.jc.keys)
    assert str(tmsg.value) == str(jmsg.value)
    with pytest.raises(NotImplementedError):
        tc.client.evaluation_keys
    ksk, bsk, pfpksk, fks = tc._evaluation_keys()
    with pytest.raises(ValueError, match="multi-partition"):
        tc.server.run(*mixed.enc, evaluation_keys=(ksk, bsk))
    moved = {k: dataclasses.replace(v, planes=v.planes.to("meta"))
             for k, v in fks.items()}
    with pytest.raises(ValueError, match="server runs on cpu"):
        tc.server.run(*mixed.enc,
                      evaluation_keys=(ksk, bsk, pfpksk, moved))
    assert TMultiKeys(tc.client_specs.partitions, {},
                      cache_directory=str(tmp_path)).cache_directory \
        == str(tmp_path)


def test_mono_circuit_keeps_the_mono_paths():
    """A mono circuit: Keys, the 2-tuple, no partitions, no conversion
    keyswitch, every lookup in the one keyset's partition."""
    table = tfhe.LookupTable([2, 1, 3, 0])

    @tfhe.compiler({"x": "encrypted"})
    def f(x):
        return table[x] + tfhe.univariate(lambda v: v // 2)(x)

    c = f.compile(range(4), tfhe.Configuration(
        forced_parameters=_tparams(TEST_PARAMS_TINY_WIDE)), device="cpu")
    assert not c.client_specs.is_multi
    assert type(c.keys) is TKeys
    ex = c.server._executor
    assert ex.partitions is None and ex.conversions == {}
    assert ex.wop_params_by_width == {}
    for node in c.graph.topological_order():
        if node.name in ("tlu", "univariate"):
            assert ex.params_for_width(ex.lookup_partition(node)) == \
                c.client_specs.params
    c.keygen(seed=1)
    keys = c._evaluation_keys()
    assert len(keys) == 2
    with pytest.raises(ValueError, match="multi-partition"):
        c.server.run(np.zeros((1,), np.uint64), evaluation_keys=(
            {0: keys[0]}, {0: keys[1]}, None, {}))
    assert [c.encrypt_run_decrypt(v) for v in range(4)] == [2, 1, 4, 1]
