"""The PyTorch port's server path against the JAX package, on CPU.

A circuit compiled by the JAX package is saved as a deployment archive with
a seeded keyset; the port loads both and must produce the reference
``Server.run``'s output ciphertexts bit for bit on the same JAX-encrypted
inputs.  Also: key generation and the key formats agree across the
packages, the committed fixture is what the JAX package compiles, and the
port neither imports JAX nor falls back to the CPU.
"""

import dataclasses
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

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation.keys import Keys as TKeys
from concrete_tpu_torch.params import CryptoParams as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "concrete_tpu_torch", "fixtures",
                       "table_sub_u4_b1024.zip")
MLP_FIXTURE = os.path.join(REPO, "concrete_tpu_torch", "fixtures",
                           "mlp_q2_b64.zip")
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


@pytest.mark.parametrize("form", ["enc_mat", "enc_vec", "mat_enc",
                                  "vec_enc"])
def test_contractions_match_reference(tmp_path, form):
    """matmul / dot between an encrypted and a clear operand, every operand
    layout the executor lowers, against the JAX package's Server.run."""
    w2 = np.array([[1, -2, 0], [3, 1, -1]])
    w1 = np.array([2, -1])
    x = np.array([[1, 2], [3, 0], [2, 2]])
    x, fn = {
        "enc_mat": (x, lambda v: v @ w2),
        "enc_vec": (x, lambda v: np.dot(v, w1)),
        "mat_enc": (x.T, lambda v: w2.T @ v),
        "vec_enc": (x.T, lambda v: w1 @ v),
    }[form]
    circuit = fhe.compiler({"v": "encrypted"})(fn).compile(
        [x, np.zeros(x.shape, int), np.full(x.shape, 3)],
        fhe.Configuration(forced_parameters=TEST_PARAMS_TINY))
    path = str(tmp_path / "c.zip")
    circuit.server.save(path)
    circuit.keygen(seed=4)
    ct = circuit.encrypt(x)
    want = circuit.server.run(ct, evaluation_keys=circuit.keys.evaluation_keys)
    server = tfhe.Server.load(path, device="cpu")
    keys = TKeys.from_arrays(
        server.client_specs.params, circuit.keys.secret.lwe_small,
        circuit.keys.secret.glwe, circuit.keys.server.bsk,
        circuit.keys.server.ksk)
    got = server.run(ct, evaluation_keys=keys.evaluation_keys)
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(tfhe.Client(server.client_specs, keys)
                          .decrypt(got[0]), fn(x))


def test_mlp_server_run_matches_reference(tmp_path):
    """The slice as a whole: a QuantizedMLP whose outputs vary, at insecure
    N=2048 parameters where both packages take the fused CRT-NTT blind
    rotate in its acc32 mode, through matmul -> TLU -> matmul.  The port's
    output ciphertexts equal the JAX package's (its Pallas kernel in
    interpret mode) bit for bit, and decrypt to the clear inference."""
    from concrete_tpu.models import QuantizedMLP
    from concrete_tpu.params import CryptoParams as JParams
    from concrete_tpu_torch.ops.fused_ntt import FusedBSK, acc32_eligible
    params = JParams(
        n_small=4, glwe_dimension=1, polynomial_size=2048, pbs_level=2,
        pbs_base_log=8, ks_level=2, ks_base_log=8, lwe_std=2.0 ** -25,
        glwe_std=2.0 ** -35, security_level=0)
    mlp = QuantizedMLP(d_in=2, d_hidden=4, d_out=2, activation_bits=4,
                       seed=1)
    circuit = mlp.compile(fhe.Configuration(forced_parameters=params),
                          batch_size=2)
    specs = circuit.client_specs
    assert specs.message_bits == 7 and fused_ntt_preferred(params, 7)
    path = str(tmp_path / "mlp.zip")
    circuit.server.save(path)
    circuit.keygen(seed=5)
    x = np.random.default_rng(2).integers(0, 16, (2, 2))
    enc = circuit.encrypt(x)
    want = circuit.server.run(enc,
                              evaluation_keys=circuit.keys.evaluation_keys)
    server = tfhe.Server.load(path, device="cpu")
    keys = TKeys.from_arrays(
        server.client_specs.params, circuit.keys.secret.lwe_small,
        circuit.keys.secret.glwe, circuit.keys.server.bsk,
        circuit.keys.server.ksk)
    ev = keys.evaluation_keys
    _, bsk = ev.packed(specs.message_bits, norm2=server.graph.max_norm2(),
                       device="cpu")
    assert isinstance(bsk, FusedBSK) and acc32_eligible(bsk)
    got = server.run(enc, evaluation_keys=ev)
    assert np.array_equal(got[0], np.asarray(want[0]))
    dec = tfhe.Client(server.client_specs, keys).decrypt(got[0])
    assert np.array_equal(dec, mlp.infer_clear(x))
    assert np.any(dec != 0)


def test_client_roundtrip_and_validation(deployment):
    server = tfhe.Server.load(deployment["archive"], device="cpu")
    client = tfhe.Client(server.client_specs, device="cpu")
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
    tk.generate(seed=11, device="cpu")
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


def _assert_same_archive(committed: str, path: str) -> None:
    """Specs and array payloads byte for byte, the graph up to node uids
    (a process-global counter)."""
    with zipfile.ZipFile(committed) as a, zipfile.ZipFile(path) as b:
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


def test_fixture_is_the_reference_compile(tmp_path):
    """The committed archive is what the JAX package compiles."""
    tool = _fixture_tool()
    path = str(tmp_path / "fresh.zip")
    tool.compile_circuit().server.save(path)
    _assert_same_archive(FIXTURE, path)
    specs = json.loads(zipfile.ZipFile(FIXTURE).read("client.specs.json"))
    assert specs["params"]["polynomial_size"] == 1024
    assert specs["params"]["security_level"] == 128


def test_mlp_fixture_is_the_reference_compile(tmp_path):
    """The committed QuantizedMLP archive is what the JAX package compiles:
    128-bit N=4096 parameters, 6-bit messages, 64 samples per request."""
    tool = _fixture_tool()
    path = str(tmp_path / "fresh_mlp.zip")
    tool.compile_mlp().server.save(path)
    _assert_same_archive(MLP_FIXTURE, path)
    specs = json.loads(zipfile.ZipFile(MLP_FIXTURE).read("client.specs.json"))
    assert specs["params"]["polynomial_size"] == 4096
    assert specs["params"]["n_small"] == 822
    assert specs["params"]["security_level"] == 128
    assert specs["message_bits"] == 6
    assert specs["inputs"][0]["shape"] == [64, 8]


def _bsk_form(params, message_bits) -> str:
    """The BSK form the port packs for these parameters: all-zero keys of
    one blind-rotate step packed on the CPU (the rule reads the parameters,
    the packers only the arrays)."""
    from concrete_tpu_torch.compilation.keys import pack_evaluation
    tp = _tparams(params)
    kp1, n = tp.glwe_dimension + 1, tp.polynomial_size
    _, bsk = pack_evaluation(
        tp, np.zeros((1, tp.pbs_level, kp1, kp1, n), np.uint64),
        np.zeros((1, tp.ks_level, 2), np.uint64), message_bits, 1, "cpu")
    return type(bsk).__name__


def test_tested_params_take_the_banded_path():
    """Every parameter set the port is held to packs the BSK form the JAX
    package packs there: banded at the tested N <= 1024 sets and at the
    fixture's archive packing, fused at the fixture's parameters with
    untruncated keys (message_bits=None) and at N >= 2048 where the rule
    says so — GameOfLife(8, 8)'s 5-bit N=2048 parameters stay banded."""
    import dataclasses
    from concrete_tpu.params import CryptoParams as JParams
    fixture = tfhe.Server.load(FIXTURE, device="cpu").client_specs
    fixture_params = JParams(**dataclasses.asdict(fixture.params))
    game_of_life = JParams.make(
        n_small=758, glwe_dimension=1, polynomial_size=2048, pbs_level=2,
        pbs_base_log=7, ks_level=5, ks_base_log=3)
    mlp = JParams(**dataclasses.asdict(
        tfhe.Server.load(MLP_FIXTURE, device="cpu").client_specs.params))
    cases = [(p, mb) for p in (TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE)
             for mb in (None, 3, 4, 5)]
    cases += [(fixture_params, fixture.message_bits), (fixture_params, None),
              (game_of_life, 5), (mlp, 6), (mlp, None)]
    for p, mb in cases:
        want = "FusedBSK" if fused_ntt_preferred(p, mb) else "LimbBSK"
        assert _bsk_form(p, mb) == want, (p, mb)
    assert not fused_ntt_preferred(fixture_params, fixture.message_bits)
    assert fused_ntt_preferred(fixture_params, None)
    assert not fused_ntt_preferred(game_of_life, 5)
    assert fused_ntt_preferred(mlp, 6)


def test_default_device_is_cuda():
    """Server.load, the evaluation keys and the three key packers put
    their tensors on the card unless asked for the CPU, and raise without
    one."""
    from concrete_tpu_torch.core import kernels as tk
    from concrete_tpu_torch.ops import fused_ntt as tfn
    p = _tparams(TEST_PARAMS_TINY)
    kp1, n = p.glwe_dimension + 1, p.polynomial_size
    bsk = np.zeros((1, p.pbs_level, kp1, kp1, n), np.uint64)
    ksk = np.zeros((1, p.ks_level, p.n_small + 1), np.uint64)
    fused = dataclasses.replace(p, polynomial_size=1024, glwe_dimension=1)
    fused_bsk = np.zeros((1, fused.pbs_level, 2, 2, 1024), np.uint64)
    packers = [lambda: tk.pack_bsk(bsk, p), lambda: tk.pack_ksk(ksk, p),
               lambda: tfn.pack_bsk_fused(fused_bsk, fused,
                                          primes=(2147352577,),
                                          trunc_bits=0)]
    if torch.cuda.is_available():
        assert tfhe.Server.load(FIXTURE).device.type == "cuda"
        for pack in packers:
            assert pack().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tfhe.Server.load(FIXTURE)
        with pytest.raises(RuntimeError, match="CUDA"):
            TKeys(_tparams(TEST_PARAMS_TINY)).evaluation_for()
        for pack in packers:
            with pytest.raises(RuntimeError, match="CUDA"):
                pack()
    assert tk.pack_bsk(bsk, p, device="cpu").device.type == "cpu"
    assert tk.pack_ksk(ksk, p, device="cpu").device.type == "cpu"


def test_unported_operations_raise(tmp_path):
    """A JAX-package archive whose graph holds ``extract_bits``
    (``fhe.bits``, ROADMAP item 7, now ported) loads in the port and
    serves on its keys: the JAX package's output bits on the same
    ciphertext, which decrypt to the bit."""
    def bit1(x):
        return fhe.bits(x)[1]

    circuit = fhe.compiler({"x": "encrypted"})(bit1).compile(
        range(8), fhe.Configuration(forced_parameters=TEST_PARAMS_TINY))
    assert "extract_bits" in {n.name for n in circuit.graph.graph.nodes}
    path = str(tmp_path / "bits.zip")
    circuit.server.save(path)
    server = tfhe.Server.load(path, device="cpu")
    assert hasattr(tfhe, "bits")
    circuit.keygen(seed=4)
    keys = TKeys.from_arrays(_tparams(TEST_PARAMS_TINY),
                             circuit.keys.secret.lwe_small,
                             circuit.keys.secret.glwe,
                             circuit.keys.server.bsk,
                             circuit.keys.server.ksk)
    ct = circuit.encrypt(6)
    got = server.run(ct, evaluation_keys=keys.evaluation_keys)[0]
    want = np.asarray(circuit.server.run(
        ct, evaluation_keys=circuit.keys.evaluation_keys)[0])
    np.testing.assert_array_equal(got, want)
    assert circuit.decrypt(want) == 1


def test_port_imports_no_jax():
    code = ("import sys, concrete_tpu_torch, concrete_tpu_torch.compilation."
            "executor, concrete_tpu_torch.ops.step, "
            "concrete_tpu_torch.ops.fused_ntt, concrete_tpu_torch.ops.ntt, "
            "concrete_tpu_torch.ops.fused_latency, "
            "concrete_tpu_torch.ops.banded_mm, "
            "concrete_tpu_torch.ops.recombine, "
            "concrete_tpu_torch.optimizer.v0, concrete_tpu_torch.tracing, "
            "concrete_tpu_torch.extensions, "
            "concrete_tpu_torch.compilation.compiler, "
            "concrete_tpu_torch.compilation.circuit, "
            "concrete_tpu_torch.compilation.multi, concrete_tpu_torch.models, "
            "concrete_tpu_torch.extensions.basics, "
            "concrete_tpu_torch.extensions.array_ops, "
            "concrete_tpu_torch.extensions.control, "
            "concrete_tpu_torch.extensions.convolution, "
            "concrete_tpu_torch.extensions.tracing_ops, "
            "concrete_tpu_torch.models.game_of_life, "
            "concrete_tpu_torch.models.levenshtein, "
            "concrete_tpu_torch.models.kvdb, "
            "concrete_tpu_torch.models.xor_distance, "
            "concrete_tpu_torch.models.pir, "
            "concrete_tpu_torch.core.kernels_wop, concrete_tpu_torch.core.wop, "
            "concrete_tpu_torch.extensions.bits, "
            "concrete_tpu_torch.extensions.crt; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'concrete_tpu' or m.startswith('concrete_tpu.')]"
            "; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
