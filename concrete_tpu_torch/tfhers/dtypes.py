"""TFHE-rs radix integer types and crypto parameters.

Counterpart of ``concrete_tpu/tfhers/dtypes.py`` (stdlib only, copied).

Reference: frontends/concrete-python/concrete/fhe/tfhers/__init__.py:27-96
(dtype built from a TFHE-rs parameter JSON) and dtypes.py
(TFHERSIntegerType: bit width split into radix blocks of
message_modulus/carry_modulus under TFHE-rs' own LWE parameters).

TFHE-rs block encoding: a block value m in [0, msg_mod * carry_mod) is
encoded as m * delta with delta = q / (2 * msg_mod * carry_mod) — one
padding bit, like concrete native but per block.
"""

from __future__ import annotations

import dataclasses
import json


def _parse_std(d: dict, key: str) -> float:
    """Noise stdev from either tfhe-rs JSON shape: the nested
    {"Gaussian": {"std": x}} distribution or a flat "<key>_stdev" float."""
    v = d.get(key)
    if isinstance(v, dict):
        return float(v.get("Gaussian", {}).get("std", 0.0))
    return float(d.get(f"{key}_stdev", 0.0))


@dataclasses.dataclass(frozen=True)
class CryptoParams:
    """TFHE-rs parameter subset relevant to interop (reference
    tfhers/dtypes.py CryptoParams; values from a TFHE-rs params JSON)."""
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    pbs_base_log: int
    pbs_level: int
    lwe_noise_distribution_stdev: float
    glwe_noise_distribution_stdev: float
    message_modulus: int
    carry_modulus: int
    encryption_key_choice: str = "big"   # tfhe-rs KS_PBS order encrypts
                                         # under the big key

    @classmethod
    def from_json(cls, blob: str) -> "CryptoParams":
        d = json.loads(blob)
        return cls(
            lwe_dimension=d["lwe_dimension"],
            glwe_dimension=d["glwe_dimension"],
            polynomial_size=d["polynomial_size"],
            pbs_base_log=d["pbs_base_log"],
            pbs_level=d["pbs_level"],
            lwe_noise_distribution_stdev=_parse_std(
                d, "lwe_noise_distribution"),
            glwe_noise_distribution_stdev=_parse_std(
                d, "glwe_noise_distribution"),
            message_modulus=d["message_modulus"],
            carry_modulus=d["carry_modulus"],
        )

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size


@dataclasses.dataclass(frozen=True)
class TFHERSIntegerType:
    """A TFHE-rs radix integer: `bit_width` bits in blocks of
    log2(message_modulus) bits (reference tfhers/dtypes.py)."""
    is_signed: bool
    bit_width: int
    carry_width: int
    msg_width: int
    params: CryptoParams

    @property
    def n_blocks(self) -> int:
        return -(-self.bit_width // self.msg_width)

    @property
    def msg_modulus(self) -> int:
        return 1 << self.msg_width

    @property
    def delta_log2(self) -> int:
        # q = 2^64; one padding bit above msg+carry
        return 64 - (self.msg_width + self.carry_width + 1)

    def encode_blocks(self, value: int) -> list[int]:
        """Radix-decompose a clear value into block messages (LSB first)."""
        v = int(value) % (1 << self.bit_width)
        return [(v >> (i * self.msg_width)) & (self.msg_modulus - 1)
                for i in range(self.n_blocks)]

    def decode_blocks(self, blocks: list[int]) -> int:
        v = 0
        for i, b in enumerate(blocks):
            v |= (int(b) % self.msg_modulus) << (i * self.msg_width)
        if self.is_signed and v >= (1 << (self.bit_width - 1)):
            v -= 1 << self.bit_width
        return v


# Default parameter shells mirroring tfhe-rs' PARAM_MESSAGE_2_CARRY_2_KS_PBS
# family (the values are the published tfhe-rs 0.10 defaults).
_P_2_2 = CryptoParams(
    lwe_dimension=909, glwe_dimension=1, polynomial_size=4096,
    pbs_base_log=15, pbs_level=2,
    lwe_noise_distribution_stdev=9.743e-7,
    glwe_noise_distribution_stdev=2.168e-19,
    message_modulus=4, carry_modulus=4)


def uint8_2_2(params: CryptoParams = _P_2_2) -> TFHERSIntegerType:
    return TFHERSIntegerType(False, 8, 2, 2, params)


def uint16_2_2(params: CryptoParams = _P_2_2) -> TFHERSIntegerType:
    return TFHERSIntegerType(False, 16, 2, 2, params)


def int8_2_2(params: CryptoParams = _P_2_2) -> TFHERSIntegerType:
    return TFHERSIntegerType(True, 8, 2, 2, params)
