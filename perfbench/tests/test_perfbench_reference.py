"""The plain reference: ChaCha20 against RFC 8439, the key draw, encoding
and decryption, and each configuration's clear function, at hand-worked
values; and that nothing under perfbench/reference/ imports the program."""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from perfbench import harness
from perfbench.reference import keys

REFERENCE = os.path.join(harness.HERE, "reference")


def test_chacha20_rfc8439_block_function():
    """RFC 8439 section 2.3.2: key 00..1f, nonce 00:00:00:09:00:00:00:4a:
    00:00:00:00, block counter 1; the serialized block begins 10 f1 e7 e4
    d1 3b 59 15 50 0f dd 1f a3 20 71 c4."""
    out = keys.chacha20_blocks(bytes(range(32)),
                               bytes.fromhex("000000090000004a00000000"),
                               1, 1)
    assert out[:16] == bytes.fromhex("10f1e7e4d13b5915500fdd1fa32071c4")


def test_chacha20_zero_key_keystream():
    """RFC 8439 appendix A.1, test vector 1: all-zero key and nonce, counter
    0: the keystream begins 76 b8 e0 ad a0 f1 3d 90 40 5d 6a e5 53 86 bd 28
    bd d2 19 b8 a0 8d ed 1a a8 36 ef cc 8b 77 0d c7."""
    out = keys.chacha20_blocks(bytes(32), bytes(12), 0, 2)
    assert out[:32] == bytes.fromhex(
        "76b8e0ada0f13d90405d6ae55386bd28bdd219b8a08ded1aa836efcc8b770dc7")
    assert len(out) == 128


def test_big_key_by_hand():
    """Seed 0 is the all-zero ChaCha20 key.  With no small key to skip, the
    GLWE key's k N = 4 bits are the low bits of the first four
    little-endian words of A.1's keystream (bytes 0, 8, 16 and 24), whose
    low bytes are 0x76, 0x40, 0xbd, 0xa8: bits 0, 0, 1, 0.  A small key of 8 words takes block 0, so
    the GLWE key then starts at block 1."""
    assert keys.big_secret_key(0, 0, 1, 4).tolist() == [0, 0, 1, 0]
    block1 = np.frombuffer(keys.chacha20_blocks(bytes(32), bytes(12), 1, 1),
                           dtype="<u8")
    assert keys.big_secret_key(0, 8, 2, 2).tolist() == \
        (block1[:4] & 1).tolist()
    assert keys.seed_key(5) == bytes([5]) + bytes(31)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 3_000_000_019])
def test_big_key_is_the_program_s(seed):
    """The frozen key draw against the program's keygen on the CPU, at an
    insecure size (the tests may import the program; the reference may
    not)."""
    from concrete_tpu_torch.compilation.keys import Keys
    from concrete_tpu_torch.params import TEST_PARAMS_TINY_WIDE as p
    k = Keys(p)
    k.generate(seed, device="cpu")
    mine = keys.big_secret_key(seed, p.n_small, p.glwe_dimension,
                               p.polynomial_size)
    assert np.array_equal(mine, k.secret.lwe_big)


def test_encode_decrypt_decode_by_hand():
    """A 3-word key [1, 0, 1] and the mask [5, 7, 9]: the body 5 + 9 + m
    decrypts to the phase m.  4-bit 3 is 3 << 59; 5-bit signed -3 is
    (2^64 - 3) << 58 mod 2^64; noise below half a step rounds away."""
    sk = np.array([1, 0, 1], dtype=np.uint64)
    m = keys.encode(3, 4)
    assert int(m) == 3 << 59
    ct = np.array([5, 7, 9, (14 + int(m)) % 2 ** 64], dtype=np.uint64)
    assert int(keys.decrypt(sk, ct)) == 3 << 59
    noisy = np.uint64((3 << 59) + (1 << 57))
    assert keys.decode(noisy, 4, signed=False) == 3
    neg = keys.encode(-3, 5)
    assert int(neg) == ((2 ** 64 - 3) << 58) % 2 ** 64
    assert keys.decode(neg, 5, signed=True) == -3
    assert keys.decode(keys.encode(np.arange(-16, 16), 5), 5,
                       signed=True).tolist() == list(range(-16, 16))


def test_clear_functions_by_hand():
    tlu4 = harness.load_module(os.path.join(REFERENCE, "tlu4.py"))
    # table = (3v + 1) % 16: table[2] = 7, table[0] = 1, table[15] = 14
    assert tlu4.clear([2, 0, 15], [5, 15, 0]).tolist() == [2, -14, 14]


def test_default_key_hooks_by_hand():
    """``keys.secret_key`` is the big key of the keyset's sizes, and
    ``keys.read_output`` decrypts and decodes at the output's encoding:
    under the 3-word key [1, 0, 1], the body 5 + 9 + (2 << 59) is 4-bit 2."""
    ks = {"n_small": 8, "glwe_dimension": 2, "polynomial_size": 2}
    assert keys.secret_key(0, ks).tolist() == \
        keys.big_secret_key(0, 8, 2, 2).tolist()
    sk = np.array([1, 0, 1], dtype=np.uint64)
    ct = np.array([[5, 7, 9, 14 + (2 << 59)]], dtype=np.uint64)
    assert keys.read_output(sk, ct, {"bits": 4, "signed": False}).tolist() \
        == [2]


class _Window:
    def __init__(self, outputs):
        self.outputs = outputs
        self.indices = list(range(len(outputs)))
        self.failed = 0


class _Cell:
    """A configuration whose reference brings its own key and a tuple
    output (as a multi-partition or multi-output circuit would)."""

    class reference:
        @staticmethod
        def secret_key(seed, keyset):
            return ("key", seed)

        @staticmethod
        def read_output(secret, out, output):
            assert secret == ("key", 7)
            return tuple(np.asarray(o) for o in out)

        @staticmethod
        def clear(x):
            return (x, 2 * x)

    config = {"keyset": {}, "output": {},
              "configuration": {"p_error": 0.0}}


def test_judge_uses_the_reference_s_key_and_output_hooks():
    """Two pool entries, x = [1, 2] and [3, 4]; the second output's second
    member is off in one value: 1 wrong, over the members of the tuple;
    the third serving repeats entry 0 with a change: 1 inconsistent."""
    clear = [(np.array([1, 2]),), (np.array([3, 4]),)]
    outs = [([1, 2], [2, 4]), ([3, 4], [6, 9]), ([1, 2], [2, 5])]
    verdict = harness.judge(_Cell, 7, clear, _Window(outs), 2)
    assert verdict["checks"]["wrong"]["value"] == 1
    assert verdict["checks"]["inconsistent"]["value"] == 1
    assert verdict["correct"] is False


def test_reference_imports_only_numpy_and_the_standard_library():
    allowed = {"numpy", "hashlib", "__future__"}
    for path in glob.glob(os.path.join(REFERENCE, "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path, n)


def test_reference_loads_nothing_of_the_program():
    code = ("import glob, os, sys\n"
            "from perfbench import harness\n"
            "for p in glob.glob(os.path.join(harness.HERE, 'reference', "
            "'*.py')):\n"
            "    harness.load_module(p)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = eval(out)
    for name in ("concrete_tpu_torch", "concrete_tpu", "jax", "torch"):
        assert name not in loaded
