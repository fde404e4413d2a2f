"""The port's TFHE-rs bridge against the JAX package's, on CPU.

The cases of ``tests/test_tfhers.py`` on ``concrete_tpu_torch`` (radix
types, ``to_native``/``from_native`` circuits, the bridge with a shared
key of the circuit's dimension and of another, the framed bytes, signed
radix values, the TFHE-rs delta of exported blocks), then: the bridge's
conversion keyswitch bit-equal to the JAX package's on the same u64 key
and blocks, and its key split on the device (``kernels_wop.
split_u64_limbs``) equal to the host's ``u64_to_balanced_i8``.  The port
runs with ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from concrete_tpu.core import limbs as jlimbs
from concrete_tpu.params import TEST_PARAMS_TINY
from concrete_tpu.tfhers.bridge import Bridge as JBridge

from torch_threads import one_intra_op_thread  # noqa: F401
import concrete_tpu_torch as fhe
from concrete_tpu_torch import tfhers
from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.params import CryptoParams as TParams
from concrete_tpu_torch.tfhers.bridge import Bridge as TBridge

TINY = TParams(**dataclasses.asdict(TEST_PARAMS_TINY))
CFG = fhe.Configuration(forced_parameters=TINY)




def test_radix_encode_decode():
    t = tfhers.uint8_2_2()
    assert t.n_blocks == 4
    for v in (0, 1, 137, 255):
        blocks = t.encode_blocks(v)
        assert all(0 <= b < 4 for b in blocks)
        assert t.decode_blocks(blocks) == v
    s = tfhers.int8_2_2()
    assert s.decode_blocks(s.encode_blocks(-3)) == -3


def test_to_native_circuit():
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return tfhers.to_native(blocks, t)

    inputset = [np.array(t.encode_blocks(v)) for v in range(16)]
    circuit = f.compile(inputset, CFG, device="cpu")
    for v in (0, 5, 15):
        blocks = np.array(t.encode_blocks(v))
        for _ in range(3):
            got = circuit.encrypt_run_decrypt(blocks)
            if int(got) == v:
                break
        else:
            raise AssertionError((v, got))


def test_from_native_circuit():
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"x": "encrypted"})
    def f(x):
        return tfhers.from_native(x, t)

    circuit = f.compile(range(16), CFG, device="cpu")
    for v in (3, 9, 14):
        for _ in range(3):
            got = circuit.encrypt_run_decrypt(v)
            if list(int(g) for g in got) == t.encode_blocks(v):
                break
        else:
            raise AssertionError((v, got))


def test_bridge_import_shared_key():
    """Blocks encrypted under a shared key with the TFHE-rs encoding import
    into the circuit and compute correctly."""
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return tfhers.to_native(blocks, t)

    inputset = [np.array(t.encode_blocks(v)) for v in range(16)]
    circuit = f.compile(inputset, CFG, device="cpu")
    circuit.keygen()
    bridge = tfhers.new_bridge(circuit, {0: t})

    # "tfhe-rs side": encrypt radix blocks under the shared big key with
    # delta = 2^(64 - msg - carry - 1)
    rng = np.random.default_rng(5)
    sk = circuit.keys.secret.lwe_big
    v = 11
    blocks = np.array(t.encode_blocks(v), dtype=np.uint64)
    delta = np.uint64(1) << np.uint64(t.delta_log2)
    for _ in range(4):  # retry absorbs the tiny-params p_error
        cts = kg.encrypt_lwe_batch(rng, sk, blocks * delta,
                                   TINY.lwe_std / 64)
        imported = bridge.import_value(cts, 0)
        out = circuit.run(imported)
        if int(circuit.decrypt(out)) == v:
            break
    else:
        raise AssertionError(circuit.decrypt(out))
    # secret key serialization round-trip
    raw = bridge.serialize_input_secret_key(0)
    assert np.array_equal(np.frombuffer(raw, dtype=np.uint64), sk)


def test_keygen_with_initial_keys_foreign_key():
    """The circuit's BSK/KSK are generated FROM a foreign shared key: blocks
    encrypted under the foreign key import, run a TLU (a real bootstrap
    under the shared key), and decrypt correctly."""
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)
    table = fhe.LookupTable([(3 * v) % 16 for v in range(16)])

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return table[tfhers.to_native(blocks, t)]

    inputset = [np.array(t.encode_blocks(v)) for v in range(16)]
    circuit = f.compile(inputset, CFG, device="cpu")

    # the "tfhe-rs side" key is generated independently of the circuit
    foreign_rng = np.random.default_rng(123)
    foreign_key = ref.sample_binary_key(
        foreign_rng, (TINY.n_big,))

    bridge = tfhers.new_bridge(circuit, {0: t})
    bridge.keygen_with_initial_keys({0: foreign_key})
    # circuit's big key IS the foreign key now
    assert np.array_equal(circuit.keys.secret.lwe_big, foreign_key)

    v = 11
    blocks = np.array(t.encode_blocks(v), dtype=np.uint64)
    delta = np.uint64(1) << np.uint64(t.delta_log2)
    rng = np.random.default_rng(7)
    for _ in range(5):
        cts = kg.encrypt_lwe_batch(rng, foreign_key, blocks * delta,
                                   TINY.lwe_std / 64)
        imported = bridge.import_value(cts, 0)
        out = circuit.run(imported)
        if int(circuit.decrypt(out)) == (3 * v) % 16:
            break
    else:
        raise AssertionError(circuit.decrypt(out))

    # idempotent: same shared key does not regenerate
    bsk_before = circuit.keys.server.bsk.copy()
    bridge.keygen_with_initial_keys({0: foreign_key})
    assert np.array_equal(circuit.keys.server.bsk, bsk_before)


def test_radix_serialization_roundtrip():
    """Framed radix bytes (tfhers/serialization.py, the fheint.rs analog)
    round-trip exactly, including shortint metadata."""
    from concrete_tpu_torch.tfhers.serialization import (RadixCiphertext,
                                                   deserialize_radix,
                                                   serialize_radix)
    rng = np.random.default_rng(3)
    blocks = rng.integers(0, 1 << 63, (4, 129), dtype=np.uint64)
    ct = RadixCiphertext(blocks=blocks, message_modulus=4, carry_modulus=4,
                         degrees=np.array([3, 3, 3, 1], dtype=np.uint64),
                         noise_levels=np.ones(4, dtype=np.uint64))
    blob = serialize_radix(ct)
    back = deserialize_radix(blob)
    assert np.array_equal(back.blocks, blocks)
    assert back.message_modulus == 4 and back.carry_modulus == 4
    assert np.array_equal(back.degrees, ct.degrees)
    assert back.pbs_order == 0


def test_radix_serialization_fixed_bytes():
    """The framing is pinned: header layout and per-block order must not
    drift (a Rust codec is written against this spec)."""
    from concrete_tpu_torch.tfhers.serialization import (RadixCiphertext,
                                                   serialize_radix)
    blocks = np.array([[1, 2, 3]], dtype=np.uint64)
    ct = RadixCiphertext(blocks=blocks, message_modulus=4, carry_modulus=2,
                         degrees=np.array([3], dtype=np.uint64),
                         noise_levels=np.array([1], dtype=np.uint64))
    blob = serialize_radix(ct)
    assert blob[:4] == b"CTRX"
    import struct
    magic, version, pbs, nb, lwe, mm, cm = struct.unpack_from(
        "<4sHHIIII", blob, 0)
    assert (version, pbs, nb, lwe, mm, cm) == (1, 0, 1, 3, 4, 2)
    body = blob[struct.calcsize("<4sHHIIII"):]
    assert body == np.array([3, 1, 1, 2, 3], dtype="<u8").tobytes()


def test_radix_serialization_rejects_garbage():
    from concrete_tpu_torch.tfhers.serialization import deserialize_radix
    with pytest.raises(ValueError, match="bad magic"):
        deserialize_radix(b"NOPE" + b"\x00" * 64)
    from concrete_tpu_torch.tfhers.serialization import (RadixCiphertext,
                                                   serialize_radix)
    ct = RadixCiphertext(blocks=np.ones((1, 4), dtype=np.uint64),
                         message_modulus=4, carry_modulus=4,
                         degrees=np.ones(1, dtype=np.uint64),
                         noise_levels=np.ones(1, dtype=np.uint64))
    with pytest.raises(ValueError, match="truncated"):
        deserialize_radix(serialize_radix(ct)[:-8])


def test_bridge_cross_dimension_key_exchange():
    """A shared TFHE-rs key of a DIFFERENT dimension than the circuit's big
    key: imports keyswitch into the circuit partition, compute runs under
    the circuit's own keys, export keyswitches back — reference external
    partitions (keys_spec.rs ConversionKeySwitchKey)."""
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)
    table = fhe.LookupTable([(3 * v) % 16 for v in range(16)])

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return table[tfhers.to_native(blocks, t)]

    inputset = [np.array(t.encode_blocks(v)) for v in range(16)]
    circuit = f.compile(inputset, CFG, device="cpu")

    # foreign key dimension deliberately != circuit n_big (128)
    foreign_dim = 96
    foreign_rng = np.random.default_rng(77)
    foreign_key = ref.sample_binary_key(foreign_rng, (foreign_dim,))

    bridge = tfhers.new_bridge(circuit, {0: t})
    bridge.keygen_with_initial_keys({0: foreign_key})
    # circuit keeps its own key (dimensions differ)
    assert circuit.keys.secret.lwe_big.shape[0] == TINY.n_big
    assert bridge._import_ksk is not None

    v = 9
    blocks = np.array(t.encode_blocks(v), dtype=np.uint64)
    delta = np.uint64(1) << np.uint64(t.delta_log2)
    rng = np.random.default_rng(8)
    for _ in range(5):
        cts = kg.encrypt_lwe_batch(rng, foreign_key, blocks * delta,
                                   2.0 ** -45)
        imported = bridge.import_value(cts, 0)
        assert imported.shape[-1] == TINY.n_big + 1
        out = circuit.run(imported)
        if int(circuit.decrypt(out)) == (3 * v) % 16:
            break
    else:
        raise AssertionError(circuit.decrypt(out))

    # export path: a block ciphertext under the circuit key keyswitches
    # back to the foreign key and decrypts with the tfhe-rs encoding
    from concrete_tpu_torch.utils.csprng import SecureGenerator
    block_val = 2
    ct_native = kg.encrypt_lwe_batch(
        SecureGenerator(4), circuit.keys.secret.lwe_big,
        np.array([block_val], dtype=np.uint64) * delta, 2.0 ** -45)
    exported = bridge.export_value(ct_native, 0, t)
    assert exported.shape[-1] == foreign_dim + 1
    phase = ref.lwe_decrypt(foreign_key, exported)
    dec = int(np.round(phase[0] / float(delta))) % (
        t.msg_modulus * t.params.carry_modulus)
    assert dec == block_val


def test_bridge_serialized_roundtrip():
    """import_ciphertext/export_ciphertext speak the framed byte format."""
    from concrete_tpu_torch.tfhers.serialization import (radix_from_blocks,
                                                   serialize_radix)
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return tfhers.to_native(blocks, t)

    inputset = [np.array(t.encode_blocks(v)) for v in range(16)]
    circuit = f.compile(inputset, CFG, device="cpu")
    circuit.keygen()
    bridge = tfhers.new_bridge(circuit, {0: t})

    rng = np.random.default_rng(5)
    sk = circuit.keys.secret.lwe_big
    v = 13
    blocks = np.array(t.encode_blocks(v), dtype=np.uint64)
    delta = np.uint64(1) << np.uint64(t.delta_log2)
    for _ in range(4):
        cts = kg.encrypt_lwe_batch(rng, sk, blocks * delta,
                                   TINY.lwe_std / 64)
        blob = serialize_radix(radix_from_blocks(cts, t))
        imported = bridge.import_ciphertext(blob, 0)
        out = circuit.run(imported)
        if int(circuit.decrypt(out)) == v:
            break
    else:
        raise AssertionError(circuit.decrypt(out))

    # export to bytes and parse back
    blob_out = bridge.export_ciphertext(
        [cts[i] for i in range(t.n_blocks)], 0, t)
    from concrete_tpu_torch.tfhers.serialization import deserialize_radix
    back = deserialize_radix(blob_out)
    assert back.n_blocks == t.n_blocks
    assert np.array_equal(back.blocks, cts)


def test_to_native_signed():
    """Signed radix blocks recombine to the true signed value (the MSB
    block's TLU folds in the sign), both clear and under encryption."""
    t = tfhers.TFHERSIntegerType(True, 4, 2, 2, tfhers.uint8_2_2().params)

    # clear path
    for v in (-8, -3, -1, 0, 5, 7):
        blocks = np.array(t.encode_blocks(v))
        assert int(tfhers.to_native(blocks, t)) == v, v

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return tfhers.to_native(blocks, t)

    inputset = [np.array(t.encode_blocks(v)) for v in range(-8, 8)]
    circuit = f.compile(inputset, CFG, device="cpu")
    for v in (-8, -3, 7):
        blocks = np.array(t.encode_blocks(v))
        for _ in range(4):
            got = circuit.encrypt_run_decrypt(blocks)
            if int(got) == v:
                break
        else:
            raise AssertionError((v, got))


def test_from_native_blocks_carry_tfhers_delta():
    """from_native blocks are encoded at msg+carry bits so the exported
    ciphertext phase sits at the TFHE-rs delta; export_value validates."""
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"x": "encrypted"})
    def f(x):
        return tfhers.from_native(x, t)

    circuit = f.compile(range(16), CFG, device="cpu")
    specs = circuit.client_specs
    for pos in range(t.n_blocks):
        assert specs.output_width(pos) == t.msg_width + t.carry_width
        assert 64 - specs.output_width(pos) - 1 == t.delta_log2
    circuit.keygen()
    bridge = tfhers.new_bridge(circuit, {0: t})
    enc = circuit.encrypt(9)
    outs = circuit.run(enc)
    blob = bridge.export_ciphertext(outs, 0, t)
    radix = tfhers.deserialize_radix(blob) if hasattr(
        tfhers, "deserialize_radix") else None
    if radix is not None:
        # decrypt each exported block under the big key at the tfhers delta
        sk = circuit.keys.secret.lwe_big
        decoded = []
        for b in np.asarray(radix.blocks):
            phase = ref.lwe_decrypt(sk, b.astype(np.uint64))
            decoded.append(
                int((int(phase) + (1 << (t.delta_log2 - 1)))
                    >> t.delta_log2) % t.msg_modulus)
        assert t.decode_blocks(decoded) == 9


def test_export_value_rejects_wrong_delta():
    """A circuit output not produced by from_native (wrong encoding width)
    is rejected rather than exported at a wrong delta."""
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"x": "encrypted"})
    def f(x):
        return x + 1   # 2-bit-ish output, not msg+carry

    circuit = f.compile(range(2), CFG, device="cpu")
    circuit.keygen()
    bridge = tfhers.new_bridge(circuit, {0: t})
    enc = circuit.encrypt(1)
    out = circuit.run(enc)
    with pytest.raises(ValueError, match="delta"):
        bridge.export_value(np.asarray(out.data if hasattr(out, "data")
                                       else out), 0, t)


# -- the device pieces against the JAX package -------------------------------

def _random_ksk(rng, n_in, levels, n_out):
    return rng.integers(0, 1 << 64, (n_in, levels, n_out + 1),
                        dtype=np.uint64, endpoint=False)


def test_conversion_key_split_equals_host_split():
    """The bridge's pack splits the u64 key on the device, bit for bit the
    host split (edge values included)."""
    rng = np.random.default_rng(21)
    ksk = _random_ksk(rng, 24, 3, 40)
    ksk.reshape(-1)[:6] = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 128]
    packed = TBridge._pack(ksk, 6, 3, "cpu")
    assert packed.planes.dtype == torch.int8 and packed.device.type == "cpu"
    assert np.array_equal(packed.planes.numpy(),
                          jlimbs.u64_to_balanced_i8(ksk))
    assert np.array_equal(packed.planes.numpy(),
                          np.asarray(JBridge._pack(ksk, 6, 3).planes))
    assert (packed.base_log, packed.levels) == (6, 3)


@pytest.mark.parametrize("base_log,levels", [(6, 3), (11, 2)])
def test_conversion_keyswitch_matches_reference(base_log, levels):
    """Same u64 key, same blocks: the port's keyswitch (int8 limb GEMMs on
    the device) gives the JAX package's ciphertexts bit for bit."""
    rng = np.random.default_rng(22 + levels)
    n_in, n_out = 48, 32
    ksk = _random_ksk(rng, n_in, levels, n_out)
    blocks = rng.integers(0, 1 << 64, (4, n_in + 1), dtype=np.uint64,
                          endpoint=False)
    want = np.asarray(JBridge._keyswitch(
        blocks, JBridge._pack(ksk, base_log, levels)))
    got = TBridge._keyswitch(blocks, TBridge._pack(ksk, base_log, levels,
                                                   "cpu"))
    assert got.dtype == np.uint64 and got.shape == (4, n_out + 1)
    assert np.array_equal(got, want)


def test_bridge_keys_live_on_the_circuit_device():
    """A cross-dimension bridge packs both conversion keys on the circuit's
    device; the shared key serializes as little-endian u64."""
    t = tfhers.TFHERSIntegerType(False, 4, 2, 2, tfhers.uint8_2_2().params)

    @fhe.compiler({"blocks": "encrypted"})
    def f(blocks):
        return tfhers.to_native(blocks, t)

    inputset = [np.array(t.encode_blocks(v)) for v in range(16)]
    circuit = f.compile(inputset, CFG, device="cpu")
    key = ref.sample_binary_key(np.random.default_rng(3), (40,))
    bridge = tfhers.new_bridge(circuit, {0: t})
    bridge.keygen_with_initial_keys({0: key})
    for packed, n_in, n_out in ((bridge._import_ksk, 40, TINY.n_big),
                                (bridge._export_ksk, TINY.n_big, 40)):
        assert packed.device == circuit.device
        assert packed.planes.shape[0] == n_in
        assert packed.planes.shape[2] == n_out + 1
    assert bridge.serialize_input_secret_key(0) == key.astype("<u8").tobytes()
    with pytest.raises(NotImplementedError, match="share one"):
        tfhers.new_bridge(circuit, {0: t, 1: t}).keygen_with_initial_keys(
            {0: key, 1: 1 - key})
