"""The port's command line against the JAX package's, on CPU.

``tests/test_cli.py``'s round trip (compile, inspect, keygen, run) through
``python -m concrete_tpu_torch`` with ``--device cpu``; the archive that
the port's ``compile`` writes equal to the JAX CLI's for the same circuit
file, member by member; the seeded key file holding the JAX CLI's arrays; ``run``
on a JAX-written archive and key file; and the verbs refusing to run
without a card unless ``cpu`` is asked for.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from concrete_tpu.__main__ import main as jmain

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.__main__ import main
from test_torch_server import _assert_same_archive

CIRCUIT = (
    "import {pkg} as fhe\n"
    "@fhe.compiler({{'x': 'encrypted'}})\n"
    "def f(x):\n"
    "    return x + 1\n")


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each package's CLI compiled and keyed the same circuit: the archive
    and the seeded key file of each."""
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for pkg, fn, extra in (("concrete_tpu_torch", main, ["--device", "cpu"]),
                           ("concrete_tpu", jmain, [])):
        circ = d / f"{pkg}.py"
        circ.write_text(CIRCUIT.format(pkg=pkg))
        archive, keys = str(d / f"{pkg}.zip"), str(d / f"{pkg}.keys")
        _run(fn, ["compile", str(circ), "--function", "f", "--inputset",
                  "0:4", "--output", archive] + extra)
        _run(fn, ["keygen", archive, "--output", keys, "--seed", "7"]
             + extra)
        out[pkg] = (archive, keys)
    return out


def test_cli_roundtrip(files):
    archive, keys = files["concrete_tpu_torch"]
    shown = json.loads(_run(main, ["inspect", archive, "--device", "cpu"]))
    assert shown["pbs_count"] == 0 and shown["message_bits"] >= 2
    out = _run(main, ["run", archive, "--keys", keys, "--args", "2",
                      "--device", "cpu"])
    assert out.strip() == "3"


def test_archive_equals_reference(files):
    """The archives' members byte for byte: the specs and the arrays'
    payloads; the graph up to node uids, a process-global counter that
    differs between two compiles in one process.  The zip files' own bytes
    differ where each member is stamped with the time it was written."""
    _assert_same_archive(files["concrete_tpu"][0],
                         files["concrete_tpu_torch"][0])
    assert _run(main, ["inspect", files["concrete_tpu"][0], "--device",
                       "cpu"]) == _run(jmain, ["inspect",
                                               files["concrete_tpu"][0]])


def test_seeded_key_file_equals_reference(files):
    """The same seed gives the same keys, array by array.  The files' bytes
    differ only where np.savez stamps each zip member with the time it was
    written, so the arrays are compared, not the files."""
    with np.load(files["concrete_tpu_torch"][1]) as ours, \
            np.load(files["concrete_tpu"][1]) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for name in ours.files:
            assert np.array_equal(ours[name], theirs[name]), name


def test_run_on_reference_files(files):
    archive, keys = files["concrete_tpu"]
    out = _run(main, ["run", archive, "--keys", keys, "--args", "1",
                      "--device", "cpu"])
    assert out.strip() == "2"


@pytest.mark.parametrize("verb", ["inspect", "keygen", "run"])
def test_verbs_need_a_card_unless_cpu(files, verb, tmp_path):
    archive, keys = files["concrete_tpu_torch"]
    argv = {"inspect": ["inspect", archive],
            "keygen": ["keygen", archive, "--output",
                       str(tmp_path / "k.bin")],
            "run": ["run", archive, "--keys", keys, "--args", "0"]}[verb]
    if torch.cuda.is_available():      # the default device is the card
        _run(main, argv)
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
