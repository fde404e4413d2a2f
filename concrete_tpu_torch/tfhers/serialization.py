"""Radix ciphertext (de)serialization — the fheint.rs framing analog.

Counterpart of ``concrete_tpu/tfhers/serialization.py`` (numpy, copied):
the same bytes for the same ciphertext.

Reference: backends/concrete-cpu/implementation/src/c_api/fheint.rs (901
LoC) parses TFHE-rs `FheUint8/16/...` radix ciphertexts into raw LWE
arrays and re-assembles them; the fields it round-trips per shortint block
are the LWE body+mask, `degree`, `noise_level`, `message_modulus`,
`carry_modulus`, and `pbs_order` (tfhe-rs shortint::Ciphertext).

tfhe-rs' own wire format is bincode over serde+versioning, which cannot be
bit-reproduced without the Rust library; like the reference's capnp (a
format choice, not a crypto requirement), we fix an explicit, versioned
little-endian framing of the SAME fields so that radix ciphertexts survive
a client/server boundary and a Rust-side codec can be written against a
one-page spec:

    magic  b"CTRX" | u16 version | u16 pbs_order (0 = KS_PBS big key)
    u32 n_blocks | u32 lwe_size (n+1)
    u32 message_modulus | u32 carry_modulus
    per block: u64 degree | u64 noise_level | lwe_size x u64 (LE)

All integers little-endian.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from concrete_tpu_torch.tfhers.dtypes import TFHERSIntegerType

_MAGIC = b"CTRX"
_VERSION = 1
_HEADER = struct.Struct("<4sHHIIII")


@dataclasses.dataclass
class RadixCiphertext:
    """A parsed TFHE-rs-style radix ciphertext: (n_blocks, lwe_size) u64
    blocks, LSB block first, plus the shortint metadata fheint.rs carries."""
    blocks: np.ndarray
    message_modulus: int
    carry_modulus: int
    degrees: np.ndarray        # (n_blocks,) u64 — max attained block value
    noise_levels: np.ndarray   # (n_blocks,) u64 — tfhe-rs NoiseLevel
    pbs_order: int = 0

    @property
    def n_blocks(self) -> int:
        return int(self.blocks.shape[0])


def serialize_radix(ct: RadixCiphertext) -> bytes:
    blocks = np.ascontiguousarray(ct.blocks, dtype="<u8")
    n_blocks, lwe_size = blocks.shape
    out = [_HEADER.pack(_MAGIC, _VERSION, ct.pbs_order, n_blocks, lwe_size,
                        ct.message_modulus, ct.carry_modulus)]
    degrees = np.asarray(ct.degrees, dtype="<u8")
    noise = np.asarray(ct.noise_levels, dtype="<u8")
    for i in range(n_blocks):
        out.append(degrees[i].tobytes())
        out.append(noise[i].tobytes())
        out.append(blocks[i].tobytes())
    return b"".join(out)


def deserialize_radix(blob: bytes) -> RadixCiphertext:
    magic, version, pbs_order, n_blocks, lwe_size, msg_mod, carry_mod = \
        _HEADER.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise ValueError("not a radix ciphertext (bad magic)")
    if version > _VERSION:
        raise ValueError(f"radix ciphertext format v{version} is newer "
                         "than this library")
    off = _HEADER.size
    per_block = 16 + 8 * lwe_size
    want = off + n_blocks * per_block
    if len(blob) < want:
        raise ValueError(f"truncated radix ciphertext: {len(blob)} bytes, "
                         f"need {want}")
    degrees = np.empty(n_blocks, dtype=np.uint64)
    noise = np.empty(n_blocks, dtype=np.uint64)
    blocks = np.empty((n_blocks, lwe_size), dtype=np.uint64)
    for i in range(n_blocks):
        degrees[i] = np.frombuffer(blob, "<u8", 1, off)[0]
        noise[i] = np.frombuffer(blob, "<u8", 1, off + 8)[0]
        blocks[i] = np.frombuffer(blob, "<u8", lwe_size, off + 16)
        off += per_block
    return RadixCiphertext(blocks=blocks, message_modulus=msg_mod,
                           carry_modulus=carry_mod, degrees=degrees,
                           noise_levels=noise, pbs_order=pbs_order)


def radix_from_blocks(blocks: np.ndarray,
                      dtype: TFHERSIntegerType) -> RadixCiphertext:
    """Wrap raw (n_blocks, lwe_size) u64 blocks with fresh-ciphertext
    metadata (degree = msg_modulus - 1, noise level 1 — what tfhe-rs
    assigns right after encryption)."""
    blocks = np.asarray(blocks, dtype=np.uint64)
    n_blocks = blocks.shape[0]
    msg_mod = dtype.msg_modulus
    return RadixCiphertext(
        blocks=blocks, message_modulus=msg_mod,
        carry_modulus=dtype.params.carry_modulus,
        degrees=np.full(n_blocks, msg_mod - 1, dtype=np.uint64),
        noise_levels=np.ones(n_blocks, dtype=np.uint64))


def serialize_lwe_secret_key(key: np.ndarray) -> bytes:
    """Raw LE u64 key dump (fheint.rs concrete_cpu_tfhers_unknown_noise_level
    -adjacent key export is the same flat array)."""
    return np.ascontiguousarray(np.asarray(key), dtype="<u8").tobytes()


def deserialize_lwe_secret_key(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype="<u8").astype(np.uint64)
