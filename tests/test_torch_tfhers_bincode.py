"""The port's tfhe-rs wire codec against the JAX package's, on CPU.

The cases of ``tests/test_tfhers_bincode.py`` on ``concrete_tpu_torch``
(hand-authored ``FheUint4`` bytes parsed and written, random round trips,
CTRX transcoding, malformed inputs failing closed, real tfhe-rs captures
where vendored), then the port's bytes equal to the JAX package's for the
same radix ciphertext, in both framings, and each package parsing the
other's bytes.
"""

import glob
import os
import struct

import numpy as np
import pytest

from concrete_tpu.tfhers import bincode as jbc
from concrete_tpu.tfhers import serialization as jser

from torch_threads import one_intra_op_thread  # noqa: F401
from concrete_tpu_torch.tfhers import bincode as bc
from concrete_tpu_torch.tfhers.serialization import (RadixCiphertext,
                                                     deserialize_radix,
                                                     serialize_radix)


def _hand_authored_fheuint4() -> tuple[bytes, np.ndarray]:
    """A FheUint4 (2 blocks of 2+2 bits, lwe_size 3) written byte-by-byte
    per docs/tfhers_wire.md."""
    lwes = np.array([[11, 22, 33], [44, 55, 66]], dtype=np.uint64)
    out = b""

    def s(string):
        raw = string.encode()
        return struct.pack("<Q", len(raw)) + raw

    out += s("0.1") + s("0.1") + s("high_level_api::FheUint")
    out += struct.pack("<I", 0)            # FheUintVersions::V0
    out += struct.pack("<I", 0)            # InnerCiphertext Cpu
    out += struct.pack("<I", 0)            # RadixCiphertextVersions::V0
    out += struct.pack("<Q", 2)            # 2 blocks
    for row in lwes:
        out += struct.pack("<I", 0)        # CiphertextVersions::V0
        out += struct.pack("<I", 0)        # LweCiphertextVersions::V0
        out += struct.pack("<Q", 3)        # data len
        out += row.astype("<u8").tobytes()
        out += struct.pack("<I", 0)        # CiphertextModulusVersions::V0
        out += struct.pack("<QQ", 0, 0)    # u128 native modulus
        out += struct.pack("<I", 0) + struct.pack("<Q", 3)   # degree
        out += struct.pack("<I", 0) + struct.pack("<Q", 1)   # noise lvl
        out += struct.pack("<I", 0) + struct.pack("<Q", 4)   # msg mod
        out += struct.pack("<I", 0) + struct.pack("<Q", 4)   # carry mod
        out += struct.pack("<I", 0)        # PBSOrder::KeyswitchBootstrap
    out += struct.pack("<I", 0)            # FheUintId
    return out, lwes


def test_deserialize_hand_authored_bytes():
    blob, lwes = _hand_authored_fheuint4()
    ct = bc.deserialize_fheuint(blob, expected_width=4)
    np.testing.assert_array_equal(ct.blocks, lwes)
    assert ct.message_modulus == 4
    assert ct.carry_modulus == 4
    assert ct.pbs_order == bc.PBS_ORDER_KS_PBS
    assert list(ct.degrees) == [3, 3]
    assert list(ct.noise_levels) == [1, 1]


def test_serialize_matches_hand_authored_bytes():
    blob, lwes = _hand_authored_fheuint4()
    ct = RadixCiphertext(
        blocks=lwes, message_modulus=4, carry_modulus=4,
        degrees=np.array([3, 3], dtype=np.uint64),
        noise_levels=np.array([1, 1], dtype=np.uint64), pbs_order=0)
    assert bc.serialize_fheuint(ct, 4) == blob


def test_roundtrip_random():
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 1 << 63, (4, 1025), dtype=np.uint64)
    ct = RadixCiphertext(
        blocks=blocks, message_modulus=4, carry_modulus=8,
        degrees=np.full(4, 3, dtype=np.uint64),
        noise_levels=np.ones(4, dtype=np.uint64), pbs_order=1)
    out = bc.deserialize_fheuint(bc.serialize_fheuint(ct, 8))
    np.testing.assert_array_equal(out.blocks, ct.blocks)
    assert out.message_modulus == 4 and out.carry_modulus == 8
    assert out.pbs_order == 1


def test_ctrx_transcoding_roundtrip():
    rng = np.random.default_rng(6)
    blocks = rng.integers(0, 1 << 62, (2, 9), dtype=np.uint64)
    ct = RadixCiphertext(
        blocks=blocks, message_modulus=4, carry_modulus=4,
        degrees=np.array([3, 2], dtype=np.uint64),
        noise_levels=np.ones(2, dtype=np.uint64))
    ctrx = serialize_radix(ct)
    tfhers_bytes = bc.ctrx_to_bincode(ctrx)
    back = bc.bincode_to_ctrx(tfhers_bytes)
    out = deserialize_radix(back)
    np.testing.assert_array_equal(out.blocks, ct.blocks)
    assert out.message_modulus == ct.message_modulus
    np.testing.assert_array_equal(out.degrees, ct.degrees)


def test_malformed_inputs_fail_closed():
    blob, _ = _hand_authored_fheuint4()
    with pytest.raises(ValueError):
        bc.deserialize_fheuint(blob[:40])          # truncated
    with pytest.raises(ValueError):
        bc.deserialize_fheuint(b"\x00" * 64)       # garbage header
    bad = bytearray(blob)
    bad[8:11] = b"9.9"                             # wrong header version is
    ct = bc.deserialize_fheuint(bytes(bad))        # tolerated (fwd compat)
    assert ct.n_blocks == 2
    with pytest.raises(ValueError):
        bc.deserialize_fheuint(blob, expected_width=8)   # width mismatch


def test_real_tfhers_captures_if_present():
    """Auto-discover real tfhe-rs safe_serialize captures (docs/
    tfhers_wire.md validation plan).  Skips when none are vendored."""
    fixture_dir = os.path.join(os.path.dirname(__file__), "data", "tfhers")
    captures = sorted(glob.glob(os.path.join(fixture_dir, "*.bin")))
    if not captures:
        pytest.skip("no real tfhe-rs captures vendored yet "
                    "(see docs/tfhers_wire.md)")
    for path in captures:
        with open(path, "rb") as f:
            ct = bc.deserialize_fheuint(f.read())
        assert ct.n_blocks >= 1


def _radix(rng, cls, n_blocks=4, lwe_size=257, pbs_order=0):
    return cls(blocks=rng.integers(0, 1 << 64, (n_blocks, lwe_size),
                                   dtype=np.uint64, endpoint=False),
               message_modulus=4, carry_modulus=4,
               degrees=np.array([3, 2, 3, 1][:n_blocks], dtype=np.uint64),
               noise_levels=np.arange(1, n_blocks + 1, dtype=np.uint64),
               pbs_order=pbs_order)


@pytest.mark.parametrize("pbs_order", [0, 1])
def test_bytes_equal_reference(pbs_order):
    """The same radix ciphertext in both packages: equal bincode and CTRX
    bytes, and the radix_from_blocks wrapper's metadata equal."""
    ours = _radix(np.random.default_rng(9), RadixCiphertext,
                  pbs_order=pbs_order)
    theirs = _radix(np.random.default_rng(9), jser.RadixCiphertext,
                    pbs_order=pbs_order)
    assert bc.serialize_fheuint(ours, 8) == jbc.serialize_fheuint(theirs, 8)
    assert serialize_radix(ours) == jser.serialize_radix(theirs)
    ctrx = serialize_radix(ours)
    assert bc.ctrx_to_bincode(ctrx) == jbc.ctrx_to_bincode(ctrx)
    assert bc.bincode_to_ctrx(bc.ctrx_to_bincode(ctrx)) == ctrx


def test_each_package_parses_the_other():
    from concrete_tpu.tfhers import dtypes as jdt
    from concrete_tpu_torch.tfhers import dtypes as tdt
    from concrete_tpu_torch.tfhers.serialization import radix_from_blocks
    rng = np.random.default_rng(10)
    blocks = rng.integers(0, 1 << 64, (4, 33), dtype=np.uint64,
                          endpoint=False)
    ours = radix_from_blocks(blocks, tdt.uint8_2_2())
    theirs = jser.radix_from_blocks(blocks, jdt.uint8_2_2())
    blob = bc.serialize_fheuint(ours, 8)
    assert blob == jbc.serialize_fheuint(theirs, 8)
    for parsed in (bc.deserialize_fheuint(jbc.serialize_fheuint(theirs, 8),
                                          expected_width=8),
                   jbc.deserialize_fheuint(blob, expected_width=8)):
        assert np.array_equal(parsed.blocks, blocks)
        assert list(parsed.degrees) == [3] * 4
        assert list(parsed.noise_levels) == [1] * 4
        assert (parsed.message_modulus, parsed.carry_modulus) == (4, 4)
    assert np.array_equal(
        deserialize_radix(jser.serialize_radix(theirs)).blocks, blocks)
