"""tfhe-rs wire-format codec: bincode + safe_serialization framing.

Counterpart of ``concrete_tpu/tfhers/bincode.py`` (numpy, copied): the
same bytes for the same radix ciphertext.

The reference imports/exports TFHE-rs `FheUint*` radix ciphertexts through
`tfhe::safe_serialization::safe_deserialize` (backends/concrete-cpu/
implementation/src/c_api.rs:68, called from c_api/fheint.rs's
`tfhers_int_to_lwe_array` macros).  That wire format is, concretely:

  1. a `SerializationHeader` and  2. the "versionized" value,
  both encoded with **bincode 1.x, fixint encoding, little-endian**
  (`bincode::DefaultOptions::new().with_fixint_encoding()`), i.e.:

    - u8..u64:   fixed-width little-endian
    - usize:     u64 little-endian
    - bool:      single byte 0/1
    - String:    u64 length + UTF-8 bytes
    - Vec<T>:    u64 length + elements
    - enum:      u32 variant index + payload
    - struct:    fields in declaration order, no tags or padding

  The versioning layer (tfhe-versionable) wraps every (sub)object in a
  `*Versions` enum whose `V<n>` variant index is the object version; for
  the tfhe-rs 0.10 types the reference pins (Cargo.toml `tfhe = "0.10.0"`)
  all relevant objects are at V0 except where noted in _SCHEMA below.

SCHEMA STATUS — read before trusting bytes:
  * The bincode primitive layer below is the published bincode 1.x fixint
    spec and is exact.
  * The per-type field schema is derived from the tfhe-rs 0.10 public
    sources and the field set concrete-cpu round-trips
    (fheint.rs TfhersFheIntDescription: lwe data, degree, noise_level,
    message_modulus, carry_modulus, pbs_order).  The tfhe-rs submodule in
    this checkout is an empty stub and the build has no network or Rust
    toolchain, so the nesting/variant indices marked UNVERIFIED in
    _SCHEMA could not be checked against bytes produced by the real
    library this round.  `tests/test_tfhers_bincode.py` validates against
    hand-authored byte fixtures written from this spec (independent of
    the codec implementation) and round-trips; swap in real tfhe-rs
    captures as soon as an environment with tfhe-rs exists.

docs/tfhers_wire.md holds the one-page byte-layout spec.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from concrete_tpu_torch.tfhers.serialization import RadixCiphertext

# ---------------------------------------------------------------------------
# bincode 1.x fixint little-endian primitives (exact, published spec)
# ---------------------------------------------------------------------------


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", v))

    def usize(self, v):
        self.u64(v)

    def boolean(self, v):
        self.u8(1 if v else 0)

    def string(self, s: str):
        raw = s.encode("utf-8")
        self.u64(len(raw))
        self.parts.append(raw)

    def vec_u64(self, arr):
        arr = np.ascontiguousarray(np.asarray(arr, dtype="<u8"))
        self.u64(arr.size)
        self.parts.append(arr.tobytes())

    def enum(self, variant: int):
        self.u32(variant)

    def bytes_raw(self, b: bytes):
        self.parts.append(b)

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class Reader:
    def __init__(self, blob: bytes):
        self.blob = blob
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.blob):
            raise ValueError(
                f"bincode: truncated input (need {n} bytes at offset "
                f"{self.pos}, have {len(self.blob) - self.pos})")
        out = self.blob[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def usize(self) -> int:
        return self.u64()

    def boolean(self) -> bool:
        v = self.u8()
        if v not in (0, 1):
            raise ValueError(f"bincode: invalid bool byte {v}")
        return v == 1

    def string(self) -> str:
        n = self.u64()
        if n > len(self.blob):
            raise ValueError(f"bincode: string length {n} exceeds input")
        return self._take(n).decode("utf-8")

    def vec_u64(self) -> np.ndarray:
        n = self.u64()
        if n * 8 > len(self.blob) - self.pos:
            raise ValueError(f"bincode: vec<u64> length {n} exceeds input")
        return np.frombuffer(self._take(8 * n), dtype="<u8").copy()

    def enum(self, expect: int = None, what: str = "enum") -> int:
        v = self.u32()
        if expect is not None and v != expect:
            raise ValueError(
                f"bincode: {what} variant {v}, expected {expect}")
        return v

    def done(self) -> bool:
        return self.pos == len(self.blob)


# ---------------------------------------------------------------------------
# tfhe-rs 0.10 safe_serialization + type schema
# ---------------------------------------------------------------------------

#: safe_serialization header constants (tfhe-rs 0.10
#: src/safe_serialization.rs).  UNVERIFIED against real bytes — see module
#: docstring.
HEADER_VERSION = "0.1"
VERSIONING_VERSION = "0.1"

#: `Named::NAME` of the high-level integer types (tfhe-rs
#: high_level_api).  UNVERIFIED.
FHEUINT_NAME = "high_level_api::FheUint"
FHEINT_NAME = "high_level_api::FheInt"

#: tfhe-rs 0.10 PBSOrder enum variant indices (shortint/parameters):
#: KeyswitchBootstrap = 0, BootstrapKeyswitch = 1 (matches fheint.rs
#: ks_first <-> PBSOrder::KeyswitchBootstrap).
PBS_ORDER_KS_PBS = 0
PBS_ORDER_PBS_KS = 1

#: CiphertextModulus for the native u64 modulus: serialized as the
#: 128-bit value 0 meaning "native" (tfhe-rs core_crypto
#: CiphertextModulus<u64> stores a u128 where 0 encodes 2^64).
NATIVE_MODULUS_U128 = 0


@dataclasses.dataclass
class SerializationHeader:
    header_version: str
    versioning_version: str
    name: str

    def write(self, w: Writer):
        w.string(self.header_version)
        w.string(self.versioning_version)
        w.string(self.name)

    @classmethod
    def read(cls, r: Reader) -> "SerializationHeader":
        return cls(r.string(), r.string(), r.string())


def _write_lwe_ciphertext(w: Writer, data: np.ndarray):
    """core_crypto LweCiphertext<Vec<u64>>: versioned wrapper + fields
    {data: Vec<u64>, ciphertext_modulus}."""
    w.enum(0)                    # LweCiphertextVersions::V0   [UNVERIFIED]
    w.vec_u64(data)
    # CiphertextModulusVersions::V0 { modulus: u128 }
    w.enum(0)                    # [UNVERIFIED]
    w.u64(NATIVE_MODULUS_U128 & ((1 << 64) - 1))
    w.u64(NATIVE_MODULUS_U128 >> 64)


def _read_lwe_ciphertext(r: Reader) -> np.ndarray:
    r.enum(0, "LweCiphertextVersions")
    data = r.vec_u64()
    r.enum(0, "CiphertextModulusVersions")
    lo, hi = r.u64(), r.u64()
    if (hi << 64) | lo != NATIVE_MODULUS_U128:
        raise ValueError("tfhers bincode: non-native ciphertext modulus")
    return data


def _write_shortint_block(w: Writer, lwe: np.ndarray, degree: int,
                          noise_level: int, message_modulus: int,
                          carry_modulus: int, pbs_order: int):
    """shortint::Ciphertext (tfhe-rs 0.10 shortint/ciphertext): fields in
    declaration order {ct, degree, noise_level, message_modulus,
    carry_modulus, pbs_order} — the exact field set fheint.rs round-trips
    (TfhersFheIntDescription)."""
    w.enum(0)                    # CiphertextVersions::V0      [UNVERIFIED]
    _write_lwe_ciphertext(w, lwe)
    w.enum(0)                    # DegreeVersions::V0          [UNVERIFIED]
    w.usize(degree)
    w.enum(0)                    # NoiseLevelVersions::V0      [UNVERIFIED]
    w.usize(noise_level)
    w.enum(0)                    # MessageModulusVersions::V0  [UNVERIFIED]
    w.usize(message_modulus)
    w.enum(0)                    # CarryModulusVersions::V0    [UNVERIFIED]
    w.usize(carry_modulus)
    w.enum(pbs_order)            # PBSOrder variant index
    return w


def _read_shortint_block(r: Reader):
    r.enum(0, "CiphertextVersions")
    lwe = _read_lwe_ciphertext(r)
    r.enum(0, "DegreeVersions")
    degree = r.usize()
    r.enum(0, "NoiseLevelVersions")
    noise_level = r.usize()
    r.enum(0, "MessageModulusVersions")
    message_modulus = r.usize()
    r.enum(0, "CarryModulusVersions")
    carry_modulus = r.usize()
    pbs_order = r.enum(None, "PBSOrder")
    if pbs_order not in (PBS_ORDER_KS_PBS, PBS_ORDER_PBS_KS):
        raise ValueError(f"tfhers bincode: bad PBSOrder {pbs_order}")
    return lwe, degree, noise_level, message_modulus, carry_modulus, \
        pbs_order


def serialize_fheuint(ct: RadixCiphertext, width: int) -> bytes:
    """Serialize a radix ciphertext as tfhe-rs 0.10 `safe_serialize`d
    FheUint<width> bytes (schema caveats in the module docstring).

    Layout: SerializationHeader, then the versionized value:
    FheUintVersions::V0 { ciphertext: RadixCiphertextVersions::V0
    { blocks: Vec<shortint::Ciphertext> }, id }.
    """
    w = Writer()
    SerializationHeader(HEADER_VERSION, VERSIONING_VERSION,
                        FHEUINT_NAME).write(w)
    w.enum(0)                    # FheUintVersions::V0         [UNVERIFIED]
    w.enum(0)                    # InnerCiphertextVersions/Cpu [UNVERIFIED]
    w.enum(0)                    # RadixCiphertextVersions::V0 [UNVERIFIED]
    w.u64(ct.n_blocks)           # Vec<Ciphertext> length
    for i in range(ct.n_blocks):
        _write_shortint_block(
            w, ct.blocks[i], int(ct.degrees[i]), int(ct.noise_levels[i]),
            ct.message_modulus, ct.carry_modulus, ct.pbs_order)
    w.enum(0)                    # FheUintId unit struct       [UNVERIFIED]
    return w.getvalue()


def deserialize_fheuint(blob: bytes,
                        expected_width: int = None) -> RadixCiphertext:
    """Parse tfhe-rs 0.10 `safe_serialize`d FheUint bytes into a
    RadixCiphertext — the Python analog of
    `concrete_cpu_tfhers_uint8_to_lwe_array` (fheint.rs), with the same
    validation set as TfhersFheIntDescription.is_similar."""
    r = Reader(blob)
    header = SerializationHeader.read(r)
    if header.name not in (FHEUINT_NAME, FHEINT_NAME):
        raise ValueError(f"tfhers bincode: unexpected type {header.name!r}")
    r.enum(0, "FheUintVersions")
    r.enum(0, "InnerCiphertext")
    r.enum(0, "RadixCiphertextVersions")
    n_blocks = r.u64()
    if n_blocks == 0 or n_blocks > 4096:
        raise ValueError(f"tfhers bincode: bad block count {n_blocks}")
    blocks, degrees, noises = [], [], []
    msg_mod = carry_mod = pbs_order = None
    for _ in range(n_blocks):
        lwe, deg, nl, mm, cm, po = _read_shortint_block(r)
        if msg_mod is None:
            msg_mod, carry_mod, pbs_order = mm, cm, po
        elif (mm, cm, po) != (msg_mod, carry_mod, pbs_order):
            raise ValueError("tfhers bincode: inconsistent block metadata")
        if blocks and lwe.size != blocks[0].size:
            raise ValueError("tfhers bincode: inconsistent lwe sizes")
        blocks.append(lwe)
        degrees.append(deg)
        noises.append(nl)
    r.enum(0, "FheUintId")
    if expected_width is not None:
        bits_per_block = (msg_mod.bit_length() - 1)
        if bits_per_block * n_blocks != expected_width:
            raise ValueError(
                f"tfhers bincode: {n_blocks} x {bits_per_block}-bit blocks "
                f"!= expected width {expected_width}")
    return RadixCiphertext(
        blocks=np.stack(blocks), message_modulus=msg_mod,
        carry_modulus=carry_mod,
        degrees=np.asarray(degrees, dtype=np.uint64),
        noise_levels=np.asarray(noises, dtype=np.uint64),
        pbs_order=pbs_order)


# ---------------------------------------------------------------------------
# CTRX <-> bincode transcoding
# ---------------------------------------------------------------------------

def ctrx_to_bincode(blob: bytes, width: int = None) -> bytes:
    """Transcode a CTRX-framed radix ciphertext (tfhers/serialization.py)
    to tfhe-rs safe_serialization bytes."""
    from concrete_tpu_torch.tfhers.serialization import deserialize_radix
    ct = deserialize_radix(blob)
    bits = ct.message_modulus.bit_length() - 1
    return serialize_fheuint(ct, width or bits * ct.n_blocks)


def bincode_to_ctrx(blob: bytes) -> bytes:
    """Transcode tfhe-rs safe_serialization bytes to the CTRX framing."""
    from concrete_tpu_torch.tfhers.serialization import serialize_radix
    return serialize_radix(deserialize_fheuint(blob))
