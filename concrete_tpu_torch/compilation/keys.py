"""Key management: generation, save/load, packing for the device.

Counterpart of ``concrete_tpu/compilation/keys.py`` ``Keys``: the same
ChaCha20 keygen (same seed, same keys), the same data-only npz format, and
the same BSK truncation.  Packing puts the key material on a torch device
in the form the JAX package would pick: int8 limb planes for the banded
blind rotate or per-prime NTT spectra for the fused CRT-NTT one.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core.refimpl import SecretKeys, ServerKeys
from concrete_tpu_torch.params import CryptoParams, choose_truncate_limbs
from concrete_tpu_torch.utils.device import resolve_device


def pack_evaluation(params: CryptoParams, bsk: np.ndarray, ksk: np.ndarray,
                    message_bits: Optional[int], norm2: float, device):
    """(LimbKSK, LimbBSK) or (LimbKSK, FusedBSK) on `device`: the packing
    policy of the JAX package's ``Keys.evaluation_for``.  Its BSK-form rule
    (``optimizer.v0.use_fused``, with the ``CONCRETE_TPU_FUSED_NTT``
    override) picks the form; given `message_bits`, the BSK is truncated as
    far as is provably negligible (limbs for the banded form, bits and
    primes for the fused one)."""
    from concrete_tpu_torch.optimizer.v0 import use_fused
    ksk_packed = kn.pack_ksk(ksk, params, device=device)
    if use_fused(params, message_bits):
        from concrete_tpu_torch.ops.fused_ntt import pack_bsk_fused
        return ksk_packed, pack_bsk_fused(bsk, params,
                                          message_bits=message_bits,
                                          norm2=norm2, device=device)
    truncate = 0 if message_bits is None else choose_truncate_limbs(
        params, message_bits, norm2=norm2)
    return ksk_packed, kn.pack_bsk(bsk, params, truncate_limbs=truncate,
                                   device=device)


class Keys:
    """Client secret keys + server evaluation keys for one parameter set."""

    _FORMAT_VERSION = 1

    def __init__(self, params: CryptoParams):
        self.params = params
        self._secret: Optional[SecretKeys] = None
        self._server: Optional[ServerKeys] = None
        # WoP packing keys (u64), one per (pfks_level, pfks_base_log)
        self._pfpksk: dict[tuple, np.ndarray] = {}
        self._packed: dict = {}
        self._packed_pfpksk: dict = {}

    @classmethod
    def from_arrays(cls, params: CryptoParams, lwe_small, glwe, bsk,
                    ksk) -> "Keys":
        """Keys from the JAX package's numpy arrays (u64)."""
        keys = cls(params)
        keys._secret = SecretKeys(lwe_small=np.asarray(lwe_small),
                                  glwe=np.asarray(glwe))
        keys._server = ServerKeys(bsk=np.asarray(bsk), ksk=np.asarray(ksk))
        return keys

    @property
    def are_generated(self) -> bool:
        return self._secret is not None

    def generate(self, seed: Optional[int] = None) -> None:
        """All key material from the ChaCha20 CSPRNG, seeded from
        os.urandom by default and deterministically from `seed`."""
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        self._secret, self._server = kg.keygen(SecureGenerator(seed),
                                               self.params)
        self._packed = {}
        self._pfpksk = {}
        self._packed_pfpksk = {}

    @property
    def secret(self) -> SecretKeys:
        self._require()
        return self._secret

    @property
    def server(self) -> ServerKeys:
        self._require()
        if self._server is None:
            raise RuntimeError("this keyset has no evaluation keys")
        return self._server

    @property
    def evaluation_keys(self):
        """The public key material to ship to a server."""
        from concrete_tpu_torch.compilation.evaluation_keys import \
            EvaluationKeys
        return EvaluationKeys.from_keys(self)

    def evaluation_for(self, message_bits=None, norm2: float = 1,
                       device=None):
        """Packed (LimbKSK, LimbBSK or FusedBSK) on `device` (default
        CUDA)."""
        device = resolve_device(device)
        key = (message_bits, float(norm2), str(device))
        if key not in self._packed:
            self._packed[key] = pack_evaluation(
                self.params, self.server.bsk, self.server.ksk, message_bits,
                norm2, device)
        return self._packed[key]

    def wop_keys(self, wop_params) -> np.ndarray:
        """The u64 PFPKSK of `wop_params`' pfks gadget, generated at first
        use (``core/wop.pfpksk_gen`` from the ChaCha20 CSPRNG seeded from
        os.urandom, as the JAX package's ``Keys.wop_evaluation`` does)."""
        from concrete_tpu_torch.core import wop
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        self._require()
        key = (wop_params.pfks_level, wop_params.pfks_base_log)
        if key not in self._pfpksk:
            self._pfpksk[key] = wop.pfpksk_gen(
                SecureGenerator(), self._secret, wop_params).pfpksk
        return self._pfpksk[key]

    def wop_evaluation(self, wop_params, device=None):
        """The PFPKSK packed as int8 limb planes on `device` (default
        CUDA), generated lazily per pfks gadget; cached."""
        from concrete_tpu_torch.core import kernels_wop as kw
        device = resolve_device(device)
        key = (wop_params.pfks_level, wop_params.pfks_base_log, str(device))
        if key not in self._packed_pfpksk:
            self._packed_pfpksk[key] = kw.pack_pfpksk(
                self.wop_keys(wop_params), wop_params, device=device)
        return self._packed_pfpksk[key]

    def _require(self):
        if self._secret is None:
            raise RuntimeError("keys are not generated yet; call generate()")

    # -- serialization (the JAX package's npz format) -----------------------

    def _to_npz_dict(self) -> dict:
        self._require()
        header = {"version": self._FORMAT_VERSION,
                  "params": dataclasses.asdict(self.params)}
        out = {"header": np.frombuffer(json.dumps(header).encode(),
                                       dtype=np.uint8),
               "lwe_small": self._secret.lwe_small,
               "glwe": self._secret.glwe}
        if self._server is not None:
            out["bsk"] = self._server.bsk
            out["ksk"] = self._server.ksk
        for (lev, base), pfpksk in self._pfpksk.items():
            out[f"pfpksk_{lev}_{base}"] = pfpksk
        return out

    def _from_npz(self, z) -> None:
        header = json.loads(bytes(np.asarray(z["header"])).decode())
        if header.get("version", 0) > self._FORMAT_VERSION:
            raise ValueError("key file format is newer than this library")
        if CryptoParams(**header["params"]) != self.params:
            raise ValueError("key file was generated for other parameters")
        self._secret = SecretKeys(lwe_small=np.asarray(z["lwe_small"]),
                                  glwe=np.asarray(z["glwe"]))
        self._server = ServerKeys(bsk=np.asarray(z["bsk"]),
                                  ksk=np.asarray(z["ksk"])) \
            if "bsk" in z.files else None
        self._pfpksk = {}
        for name in z.files:
            if name.startswith("pfpksk_"):
                _, lev, base = name.split("_")
                self._pfpksk[(int(lev), int(base))] = np.asarray(z[name])
        self._packed = {}
        self._packed_pfpksk = {}

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(f, **self._to_npz_dict())

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            self._from_npz(z)
