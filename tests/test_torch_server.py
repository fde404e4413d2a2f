"""The PyTorch port's server path against the JAX package, on CPU.

A circuit compiled by the JAX package is saved as a deployment archive with
a seeded keyset; the port loads both and must produce the reference
``Server.run``'s output ciphertexts bit for bit on the same JAX-encrypted
inputs.  Also: key generation and the key formats agree across the
packages, the committed fixture is what the JAX package compiles, and the
port neither imports JAX nor falls back to the CPU.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import concrete_tpu as fhe
from concrete_tpu.compilation.evaluation_keys import \
    EvaluationKeys as JEvaluationKeys
from concrete_tpu.compilation.keys import Keys as JKeys
from concrete_tpu.core import keygen as jkg
from concrete_tpu.core import refimpl as jref
from concrete_tpu.optimizer.v0 import fused_ntt_preferred
from concrete_tpu.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE

import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation.keys import Keys as TKeys
from concrete_tpu_torch.params import CryptoParams as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "concrete_tpu_torch", "fixtures",
                       "table_sub_u4_b1024.zip")
TABLE = [(3 * v + 1) % 8 for v in range(8)]


def _fixture_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(REPO, "tools",
                                           "make_torch_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tparams(p) -> TParams:
    import dataclasses
    return TParams(**dataclasses.asdict(p))


@pytest.fixture(scope="module", params=[TEST_PARAMS_TINY,
                                        TEST_PARAMS_TINY_WIDE],
                ids=["tiny", "tiny_wide"])
def deployment(request, tmp_path_factory):
    """table[x] - y over (6,) tensors: archive, seeded keys, JAX circuit,
    and deterministic JAX-side encryptions."""
    table = fhe.LookupTable(TABLE)

    @fhe.compiler({"x": "encrypted", "y": "encrypted"})
    def table_sub(x, y):
        return table[x] - y

    rng = np.random.default_rng(0)
    inputset = [(rng.integers(0, 8, 6), rng.integers(0, 8, 6))
                for _ in range(4)] + [(np.arange(6) % 8, np.arange(6) % 8)]
    circuit = table_sub.compile(
        inputset, fhe.Configuration(forced_parameters=request.param))
    d = tmp_path_factory.mktemp("deploy")
    archive, keyfile = str(d / "server.zip"), str(d / "keys.npz")
    circuit.server.save(archive)
    circuit.keygen(seed=3)
    circuit.keys.save(keyfile)
    specs = circuit.client_specs
    x = np.array([0, 7, 3, 5, 1, 6])
    y = np.array([7, 0, 2, 5, 4, 1])
    enc_rng = np.random.default_rng(1)
    cts = tuple(jkg.encrypt_lwe_batch(
        enc_rng, circuit.keys.secret.lwe_big,
        jref.encode(v, specs.input_width(pos)), specs.params.glwe_std)
        for pos, v in enumerate((x, y)))
    return dict(circuit=circuit, archive=archive, keyfile=keyfile,
                cts=cts, want=np.array(TABLE)[x] - y)


@pytest.mark.parametrize("keys_kind", ["evaluation_keys", "packed"])
def test_server_run_matches_reference(deployment, keys_kind):
    circuit = deployment["circuit"]
    server = tfhe.Server.load(deployment["archive"], device="cpu")
    keys = TKeys(server.client_specs.params)
    keys.load(deployment["keyfile"])
    if keys_kind == "evaluation_keys":
        # the client's public keys: the server picks the BSK truncation
        want = circuit.server.run(
            *deployment["cts"], evaluation_keys=circuit.keys.evaluation_keys)
        got = server.run(*deployment["cts"],
                         evaluation_keys=keys.evaluation_keys)
        assert keys.evaluation_keys.packed(
            server.client_specs.message_bits,
            norm2=server.graph.max_norm2(),
            device="cpu")[1].truncate_limbs == 4
    else:
        # packed untruncated keys, as Circuit.keys.evaluation gives them
        want = circuit.server.run(*deployment["cts"],
                                  evaluation_keys=circuit.keys.evaluation)
        got = server.run(*deployment["cts"],
                         evaluation_keys=keys.evaluation_for(device="cpu"))
    assert len(got) == len(want) == 1
    assert got[0].dtype == np.uint64
    assert np.array_equal(got[0], np.asarray(want[0]))
    client = tfhe.Client(server.client_specs, keys)
    assert np.array_equal(client.decrypt(got[0]), deployment["want"])
    assert np.array_equal(circuit.decrypt(got[0]), deployment["want"])


@pytest.mark.parametrize("kind", ["add_mul", "neg_clear_sub"])
def test_levelled_ops_match_reference(tmp_path, kind):
    """add, subtract, negative and multiply by a clear value, around a TLU,
    against the JAX package's Server.run on the same inputs and keys.
    (Six lookups: at four or fewer the JAX package takes its latency blind
    rotate, which differs for truncated keys, ROADMAP queue 3.)"""
    values = np.array([(5 * v) % 8 for v in range(8)])
    table = fhe.LookupTable(list(values))
    if kind == "add_mul":
        def fn(x, y):
            return table[x] * 2 + y + 1
    else:
        def fn(x, y):
            return 7 - table[x] - (-y) - 2
    x, y = np.array([0, 3, 6, 7, 1, 2]), np.array([3, 0, 2, 1, 1, 0])
    circuit = fhe.compiler({"x": "encrypted", "y": "encrypted"})(fn).compile(
        [(x, y), (np.arange(6) % 8, np.arange(6) % 4),
         (np.full(6, 7), np.full(6, 3)), (np.zeros(6, int), np.zeros(6, int))],
        fhe.Configuration(forced_parameters=TEST_PARAMS_TINY_WIDE))
    path = str(tmp_path / "c.zip")
    circuit.server.save(path)
    circuit.keygen(seed=9)
    cts = circuit.encrypt(x, y)
    server = tfhe.Server.load(path, device="cpu")
    keys = TKeys.from_arrays(
        server.client_specs.params, circuit.keys.secret.lwe_small,
        circuit.keys.secret.glwe, circuit.keys.server.bsk,
        circuit.keys.server.ksk)
    got = server.run(*cts, evaluation_keys=keys.evaluation_keys)
    want = circuit.server.run(*cts,
                              evaluation_keys=circuit.keys.evaluation_keys)
    assert np.array_equal(got[0], np.asarray(want[0]))
    t = values[x]
    expect = t * 2 + y + 1 if kind == "add_mul" else 7 - t + y - 2
    assert np.array_equal(tfhe.Client(server.client_specs, keys)
                          .decrypt(got[0]), expect)


def test_client_roundtrip_and_validation(deployment):
    server = tfhe.Server.load(deployment["archive"], device="cpu")
    client = tfhe.Client(server.client_specs)
    with pytest.raises(RuntimeError):
        client.decrypt(deployment["cts"][0])
    client.keygen(seed=3)
    x = np.array([1, 2, 3, 4, 5, 6])
    _, cy = client.encrypt(x, x)
    # y is encoded at the output's width, so it decrypts as an output
    assert np.array_equal(client.decrypt(cy), x)
    with pytest.raises(ValueError):
        client.encrypt(x + 10, x)
    with pytest.raises(ValueError):
        client.encrypt(x[:3], x[:3])


@pytest.mark.parametrize("params", [TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE],
                         ids=["tiny", "tiny_wide"])
def test_keys_generate_matches_reference(params):
    tk = TKeys(_tparams(params))
    tk.generate(seed=11)
    jk = JKeys(params)
    jk.generate(seed=11)
    for name in ("lwe_small", "glwe"):
        assert np.array_equal(getattr(tk.secret, name),
                              getattr(jk.secret, name))
    assert np.array_equal(tk.server.bsk, jk.server.bsk)
    assert np.array_equal(tk.server.ksk, jk.server.ksk)


def test_key_formats_cross_load(tmp_path):
    p = TEST_PARAMS_TINY
    jk = JKeys(p)
    jk.generate(seed=5)
    jk.save(str(tmp_path / "j.npz"))
    tk = TKeys(_tparams(p))
    tk.load(str(tmp_path / "j.npz"))
    tk.save(str(tmp_path / "t.npz"))
    jk2 = JKeys(p)
    jk2.load(str(tmp_path / "t.npz"))
    ta = TKeys.from_arrays(_tparams(p), jk.secret.lwe_small, jk.secret.glwe,
                           jk.server.bsk, jk.server.ksk)
    for k in (tk, ta):
        assert np.array_equal(k.server.bsk, jk2.server.bsk)
        assert np.array_equal(k.server.ksk, jk2.server.ksk)
        assert np.array_equal(k.secret.glwe, jk2.secret.glwe)
    # evaluation keys: either package reads the other's blob
    tev = tfhe.EvaluationKeys.deserialize(jk.evaluation_keys.serialize())
    jev = JEvaluationKeys.deserialize(tev.serialize())
    assert tev.params == _tparams(p)
    assert np.array_equal(jev.bsk, jk.server.bsk)
    assert np.array_equal(jev.ksk, jk.server.ksk)
    with zipfile.ZipFile(io.BytesIO(tev.serialize())) as a, \
            zipfile.ZipFile(io.BytesIO(jk.evaluation_keys.serialize())) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name


def test_fixture_is_the_reference_compile(tmp_path):
    """The committed archive is what the JAX package compiles: specs and
    array payloads byte for byte, the graph up to node uids (a
    process-global counter)."""
    tool = _fixture_tool()
    path = str(tmp_path / "fresh.zip")
    tool.compile_circuit().server.save(path)
    with zipfile.ZipFile(FIXTURE) as a, zipfile.ZipFile(path) as b:
        assert a.read("client.specs.json") == b.read("client.specs.json")

        def graph(z):
            rec = json.loads(z.read("graph.json"))
            for node in rec["nodes"]:
                node["uid"] = None
            return rec
        assert graph(a) == graph(b)
        # npz members carry their write time; their payloads must agree
        with zipfile.ZipFile(io.BytesIO(a.read("graph_arrays.npz"))) as na, \
                zipfile.ZipFile(io.BytesIO(b.read("graph_arrays.npz"))) as nb:
            assert na.namelist() == nb.namelist()
            for name in na.namelist():
                assert na.read(name) == nb.read(name), name
    specs = json.loads(zipfile.ZipFile(FIXTURE).read("client.specs.json"))
    assert specs["params"]["polynomial_size"] == 1024
    assert specs["params"]["security_level"] == 128


def test_tested_params_take_the_banded_path():
    """The port has only the banded blind rotate; every parameter set and
    packing it is held to must be one where the JAX package picks it too.
    (At the fixture's parameters the JAX package would pack a FusedBSK for
    untruncated keys, message_bits=None; the port is held there only to
    the archive's own packing, message_bits=5.)"""
    import dataclasses
    from concrete_tpu.params import CryptoParams as JParams
    fixture = tfhe.Server.load(FIXTURE, device="cpu").client_specs
    for p in (TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE):
        for mb in (None, 3, 4, 5):
            assert not fused_ntt_preferred(p, mb), (p, mb)
    assert not fused_ntt_preferred(
        JParams(**dataclasses.asdict(fixture.params)), fixture.message_bits)
    wide = dataclasses.replace(_tparams(TEST_PARAMS_TINY),
                               polynomial_size=2048)
    keys = TKeys.from_arrays(wide, np.zeros(16, np.uint64),
                             np.zeros((2, 2048), np.uint64),
                             np.zeros((1, 2, 3, 3, 2048), np.uint64),
                             np.zeros((4096, 2, 17), np.uint64))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        keys.evaluation_for(5, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tfhe.Server.load(FIXTURE).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tfhe.Server.load(FIXTURE)
        with pytest.raises(RuntimeError, match="CUDA"):
            TKeys(_tparams(TEST_PARAMS_TINY)).evaluation_for()


def test_unported_operations_raise(tmp_path):
    @fhe.compiler({"x": "encrypted"})
    def total(x):
        return np.sum(x)

    circuit = total.compile([np.arange(4) % 4, np.arange(4) % 3],
                            fhe.Configuration(
                                forced_parameters=TEST_PARAMS_TINY))
    path = str(tmp_path / "sum.zip")
    circuit.server.save(path)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 6"):
        tfhe.Server.load(path, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, concrete_tpu_torch, concrete_tpu_torch.compilation."
            "executor, concrete_tpu_torch.ops.step; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'concrete_tpu' or m.startswith('concrete_tpu.')]"
            "; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
