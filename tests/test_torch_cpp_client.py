"""The native C++ client (``csrc/client``) against the port's server, on
CPU.

The cases of ``tests/test_cpp_client.py`` that involve the Python side,
with the port's compiler, ``Server.save`` and ``Server.run``
(``device="cpu"``) in place of the JAX package's: the native client
encrypts, the port runs, the native client decrypts, and each half alone
(the port's client decrypting the native ciphertexts, the native client
decrypting the port's); the native keygen's keyset loaded and served by
the port, its WoP keyset (PFPKSK included) through a 10-bit lookup; and
the native executor on an archive from the port's ``Server.save``, the
same ciphertexts through the port's server.

The client is built from ``csrc/client/main.cc`` and ``csrc/chacha20.c``
with the Makefile's flags into a temporary directory (``make -C csrc``
writes ``csrc/bin/``, which the JAX package's test may be building at the
same time); without the toolchain the module skips, as the JAX test does.
TEST_PARAMS_TINY has a per-PBS error rate of 1-2%, so the decrypting
cases retry, as the JAX test does.
"""

import json
import os
import subprocess

import numpy as np
import pytest

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as tfhe
from concrete_tpu_torch.compilation.server import Server
from concrete_tpu_torch.compilation.value import Value
from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.params import TEST_PARAMS_TINY, TEST_PARAMS_TINY_WIDE
from concrete_tpu_torch.utils.csprng import SecureGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "csrc")
TABLE = [(3 * v + 1) % 8 for v in range(8)]
WIDE = [(3 * i + 1) % 32 for i in range(1 << 10)]


@pytest.fixture(scope="module")
def client_bin(tmp_path_factory):
    """csrc's client, built as its Makefile builds it, in a private
    directory."""
    d = tmp_path_factory.mktemp("cpp_client")
    obj, exe = str(d / "chacha20.o"), str(d / "concrete-tpu-client")
    for cmd in (["gcc", "-O2", "-Wall", "-Wextra", "-fPIC", "-c", "-o", obj,
                 os.path.join(CSRC, "chacha20.c")],
                ["g++", "-O2", "-std=c++17", "-Wall", "-Wextra", "-fopenmp",
                 "-o", exe, os.path.join(CSRC, "client", "main.cc"), obj]):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            pytest.skip(f"native toolchain unavailable: {e}")
        if r.returncode != 0:
            pytest.skip(f"native toolchain unavailable: {r.stderr[-200:]}")
    return exe


def run_cli(client_bin, *args):
    r = subprocess.run([client_bin, *args], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return r.stdout


def _table_circuit(tail=lambda t, y: t + y, inputs=4):
    table = tfhe.LookupTable(TABLE)

    @tfhe.compiler({"x": "encrypted", "y": "encrypted"})
    def f(x, y):
        return tail(table[x], y)

    return f.compile([(i, j) for i in range(8) for j in range(inputs)],
                     tfhe.Configuration(forced_parameters=TEST_PARAMS_TINY),
                     device="cpu")


@pytest.fixture(scope="module")
def circuit():
    c = _table_circuit()
    c.keygen(seed=11)
    return c


@pytest.fixture(scope="module")
def deployment(circuit, tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    specs_path, keys_path = str(d / "specs.json"), str(d / "keys.npz")
    with open(specs_path, "w") as f:
        f.write(circuit.client_specs.serialize())
    circuit.keys.save(keys_path)
    return {"dir": str(d), "specs": specs_path, "keys": keys_path}


def _read_args(directory, count):
    out = []
    for pos in range(count):
        with open(os.path.join(directory, f"arg{pos}.ctv"), "rb") as f:
            out.append(Value.deserialize(f.read()).inner)
    return out


def _write_result(path, ct):
    with open(path, "wb") as f:
        f.write(Value(np.asarray(ct)).serialize())


def test_cpp_encrypt_port_run_cpp_decrypt(client_bin, circuit, deployment):
    """The native client encrypts, the port's Server.run (on the CPU)
    evaluates, the native client decrypts."""
    for _ in range(4):
        run_cli(client_bin, "encrypt", "--specs", deployment["specs"],
                "--keys", deployment["keys"], "--out", deployment["dir"],
                "5", "2")
        enc = _read_args(deployment["dir"], 2)
        res = circuit.server.run(
            *enc, evaluation_keys=circuit._evaluation_keys())
        res_path = os.path.join(deployment["dir"], "result0.ctv")
        _write_result(res_path, res[0])
        got = json.loads(run_cli(client_bin, "decrypt",
                                 "--specs", deployment["specs"],
                                 "--keys", deployment["keys"], res_path))
        if got == TABLE[5] + 2:
            return
    raise AssertionError(f"wrong result after retries: {got}")


def test_cpp_encrypt_port_decrypt(client_bin, circuit, deployment):
    """Ciphertexts from the native client decrypt in the port's client."""
    run_cli(client_bin, "encrypt", "--specs", deployment["specs"],
            "--keys", deployment["keys"], "--out", deployment["dir"],
            "6", "3")
    x, y = _read_args(deployment["dir"], 2)
    specs = circuit.client_specs
    for ct, want, pos in ((x, 6, 0), (y, 3, 1)):
        dec = ref.decode(ref.lwe_decrypt(circuit.keys.secret.lwe_big, ct),
                         specs.input_width(pos))
        assert int(dec) == want


def test_port_encrypt_cpp_decrypt(client_bin, circuit, deployment):
    """A result encrypted by the port's client decrypts in the native
    one."""
    width = circuit.client_specs.output_width(0)
    ct = kg.encrypt_lwe_batch(SecureGenerator(5),
                              circuit.keys.secret.lwe_big,
                              ref.encode(np.array(4), width),
                              TEST_PARAMS_TINY.lwe_std)
    res_path = os.path.join(deployment["dir"], "port_result.ctv")
    _write_result(res_path, ct)
    got = json.loads(run_cli(client_bin, "decrypt",
                             "--specs", deployment["specs"],
                             "--keys", deployment["keys"], res_path))
    assert got == 4


def test_cpp_keygen_port_run_cpp_decrypt(client_bin, tmp_path):
    """The native client generates the whole keyset; the port loads it
    verbatim and serves the circuit on it; the native client decrypts."""
    c = _table_circuit()
    specs_path, keys_path = str(tmp_path / "specs.json"), \
        str(tmp_path / "keys.npz")
    with open(specs_path, "w") as fo:
        fo.write(c.client_specs.serialize())
    run_cli(client_bin, "keygen", "--specs", specs_path, "--out", keys_path)
    c.keys.load(keys_path)
    for _ in range(4):
        run_cli(client_bin, "encrypt", "--specs", specs_path,
                "--keys", keys_path, "--out", str(tmp_path), "5", "2")
        res = c.server.run(*_read_args(str(tmp_path), 2),
                           evaluation_keys=c._evaluation_keys())
        res_path = str(tmp_path / "result0.ctv")
        _write_result(res_path, res[0])
        got = json.loads(run_cli(client_bin, "decrypt", "--specs",
                                 specs_path, "--keys", keys_path, res_path))
        if got == TABLE[5] + 2:
            return
    raise AssertionError(f"wrong result after retries: {got}")


def test_cpp_wop_keyset_serves_a_wide_lookup_in_the_port(client_bin,
                                                         tmp_path):
    """The native WoP keyset (its PFPKSK included) loaded in the port: a
    10-bit lookup through the port's WoP-PBS on those keys, the PFPKSK
    packed from the loaded u64 (none generated)."""
    table = tfhe.LookupTable(WIDE)

    @tfhe.compiler({"x": "encrypted"})
    def f(x):
        return table[x]

    c = f.compile([0, 517, 1023], tfhe.Configuration(
        forced_parameters=TEST_PARAMS_TINY_WIDE,
        forced_wop_parameters=(3, 6, 8, 4)), device="cpu")
    specs_path, keys_path = str(tmp_path / "specs.json"), \
        str(tmp_path / "keys.npz")
    with open(specs_path, "w") as fo:
        fo.write(c.client_specs.serialize())
    run_cli(client_bin, "keygen", "--specs", specs_path, "--out", keys_path)
    c.keys.load(keys_path)
    with np.load(keys_path) as z:
        loaded = z["pfpksk_8_4"]
    for m in (0, 517):
        for _ in range(4):
            got = c.encrypt_run_decrypt(m)
            if got == WIDE[m]:
                break
        assert got == WIDE[m], (m, got)
    assert "pfpksk" not in c.keys.setup_seconds      # nothing generated
    np.testing.assert_array_equal(c.keys.wop_keys(c.client_specs
                                                  .wop_params()), loaded)


def test_cpp_run_on_a_port_archive(client_bin, tmp_path):
    """The native executor runs an archive saved by the port's server; the
    same ciphertexts through the port's server (and through the archive
    loaded by the port) decrypt to the same clear result."""
    c = _table_circuit(lambda t, y: t + 2 * y - 1, inputs=3)
    specs_path, keys_path = str(tmp_path / "specs.json"), \
        str(tmp_path / "keys.npz")
    server_path = str(tmp_path / "server.zip")
    with open(specs_path, "w") as fo:
        fo.write(c.client_specs.serialize())
    c.server.save(server_path)
    run_cli(client_bin, "keygen", "--specs", specs_path, "--out", keys_path)
    c.keys.load(keys_path)
    x, y = 5, 2
    expected = TABLE[x] + 2 * y - 1
    for _ in range(4):
        run_cli(client_bin, "encrypt", "--specs", specs_path,
                "--keys", keys_path, "--out", str(tmp_path), str(x), str(y))
        run_cli(client_bin, "run", "--server", server_path,
                "--keys", keys_path, "--out", str(tmp_path),
                str(tmp_path / "arg0.ctv"), str(tmp_path / "arg1.ctv"))
        got = json.loads(run_cli(
            client_bin, "decrypt", "--specs", specs_path,
            "--keys", keys_path, str(tmp_path / "result0.ctv")))
        if got == expected:
            break
    assert got == expected, (got, expected)
    enc = _read_args(str(tmp_path), 2)
    ev = c._evaluation_keys()
    res = c.server.run(*enc, evaluation_keys=ev)
    loaded = Server.load(server_path, device="cpu").run(*enc,
                                                        evaluation_keys=ev)
    np.testing.assert_array_equal(res[0], loaded[0])
    assert c.decrypt(res[0]) == expected
