"""Bridge: import/export TFHE-rs ciphertexts into a compiled circuit.

Counterpart of ``concrete_tpu/tfhers/bridge.py``.  Reference:
frontends/concrete-python/concrete/fhe/tfhers/bridge.py:18-303 (Bridge
with import_value/export_value/keygen_with_initial_keys and
serialize_input_secret_key) over concrete-cpu's fheint.rs radix parsing.

This implementation operates at the raw-LWE level: a TFHE-rs radix
ciphertext is (n_blocks, lwe_dim + 1) u64 arrays encrypted under a shared
secret key with the TFHE-rs block encoding (delta = 2^(64 - msg - carry - 1)).
Framed byte (de)serialization lives in tfhers/serialization.py (the
fheint.rs analog); `import_ciphertext`/`export_ciphertext` speak it.

Key exchange supports two shapes:
- same dimension: the circuit's keyset is regenerated *from* the shared
  key (``Keys.generate(glwe_key=...)``), so imported ciphertexts bootstrap
  directly;
- differing dimension: the circuit keeps its own keys and the bridge
  builds big->big conversion keyswitch keys in both directions (the
  reference's external-partition ConversionKeySwitchKey,
  optimizer keys_spec.rs / converter.py:937 change-partition lowering) —
  imports keyswitch into the circuit key, exports keyswitch back out.

The conversion keys are generated on the host (from the ChaCha20 CSPRNG
seeded from os.urandom, as in the JAX package), uploaded as u64 and split
into int8 limb planes on the circuit's device
(``kernels_wop.split_u64_limbs``, bit for bit the host's
``limbs.u64_to_balanced_i8``); the keyswitches are ``core.kernels.keyswitch``
(int8 limb GEMMs) on that device.  Values cross the bridge as host u64
arrays, as ``Circuit.run`` takes and returns them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from concrete_tpu_torch.tfhers.dtypes import TFHERSIntegerType
from concrete_tpu_torch.tfhers.serialization import (deserialize_radix,
                                                     radix_from_blocks,
                                                     serialize_radix)


class Bridge:
    def __init__(self, circuit, input_types: dict[int, TFHERSIntegerType]):
        self.circuit = circuit
        self.input_types = input_types
        self._import_ksk = None   # shared key -> circuit big key (packed)
        self._export_ksk = None   # circuit big key -> shared key (packed)
        self._shared_key: Optional[np.ndarray] = None

    # -- key management ----------------------------------------------------

    def keygen_with_initial_keys(self, input_idx_to_key: dict[int, np.ndarray],
                                 force: bool = False) -> None:
        """Generate circuit keys sharing a TFHE-rs secret key (the shared-key
        model of reference bridge.py:237).

        Same dimension: the BSK/KSK are generated *from* the shared key
        (``Keys.generate(glwe_key=...)``).  Differing dimension: the circuit
        gets its own keys plus conversion keyswitch keys to/from the shared
        key (external partition, keys_spec.rs ConversionKeySwitchKey).
        """
        keys_in = {int(i): np.asarray(k, dtype=np.uint64)
                   for i, k in input_idx_to_key.items()}
        key = next(iter(keys_in.values()))
        for other in keys_in.values():
            if not np.array_equal(other, key):
                raise NotImplementedError(
                    "all bridged inputs must share one TFHE-rs secret key "
                    "(per-input keys need one conversion KSK per key; "
                    "share a key or use separate bridges)")
        params = self.circuit.client_specs.params
        keys = self.circuit.keys
        if key.size == params.n_big:
            if (not force and keys.are_generated
                    and np.array_equal(keys.secret.lwe_big, key.ravel())):
                return  # already generated from this exact shared key
            keys.generate(glwe_key=key, device=self.circuit.device)
            self._shared_key = key.ravel()
            self._import_ksk = self._export_ksk = None
            return
        # differing dimension: own keys + two conversion KSKs
        if force or not keys.are_generated:
            keys.generate(device=self.circuit.device)
        self._shared_key = key.ravel()
        self._build_conversion_keys()

    def _p_error(self) -> float:
        """The circuit's configured per-PBS error budget (conversion keys
        must honor the same target, not a hardcoded default)."""
        cfg = getattr(self.circuit, "configuration", None)
        pe = getattr(cfg, "p_error", None) if cfg is not None else None
        return pe if pe is not None else 6.3e-5

    def _build_conversion_keys(self) -> None:
        from concrete_tpu_torch.core import keygen as kg
        from concrete_tpu_torch.optimizer.v0 import (choose_fks_raw,
                                                     safe_variance_bound)
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        specs = self.circuit.client_specs
        params = specs.params
        keys = self.circuit.keys
        key = self._shared_key
        rng = SecureGenerator()
        p_error = self._p_error()
        width = max([specs.input_width(i) for i in self.input_types
                     or range(len(specs.inputs))] or [specs.message_bits])
        # 1/8 of the decision margin, matching the crossing budget split in
        # compilation/multi.py (conversion KS is one of several additive
        # noise stages sharing the margin)
        budget = safe_variance_bound(width, p_error) / 8.0
        lvl_in, base_in, _ = choose_fks_raw(
            key.size, params.n_big, params.glwe_std, budget)
        ksk_in = kg.make_ksk(rng, key, keys.secret.lwe_big,
                             base_in, lvl_in, params.glwe_std)
        # export budget: the tfhe-rs side must still decode msg+carry bits
        dtypes = list(self.input_types.values())
        t_params = dtypes[0].params if dtypes else None
        t_bits = (t_params.message_modulus * t_params.carry_modulus
                  ).bit_length() - 1 if t_params else width
        t_std = (t_params.glwe_noise_distribution_stdev
                 or params.glwe_std) if t_params else params.glwe_std
        lvl_out, base_out, _ = choose_fks_raw(
            params.n_big, key.size, t_std,
            safe_variance_bound(t_bits, p_error) / 8.0)
        ksk_out = kg.make_ksk(rng, keys.secret.lwe_big, key,
                              base_out, lvl_out, t_std)
        device = self.circuit.device
        self._import_ksk = self._pack(ksk_in, base_in, lvl_in, device)
        self._export_ksk = self._pack(ksk_out, base_out, lvl_out, device)

    @staticmethod
    def _pack(ksk_u64: np.ndarray, base_log: int, levels: int, device):
        """A u64 KSK (n_in, l, n_out+1) uploaded to `device` and split
        there into the int8 limb planes of a LimbKSK."""
        from concrete_tpu_torch.core import kernels as kn
        from concrete_tpu_torch.core.kernels_wop import split_u64_limbs
        u64 = torch.from_numpy(np.ascontiguousarray(
            ksk_u64, dtype=np.uint64).view(np.int64))
        return kn.LimbKSK(planes=split_u64_limbs(u64.to(device)),
                          base_log=base_log, levels=levels)

    @staticmethod
    def _keyswitch(blocks: np.ndarray, ksk) -> np.ndarray:
        """u64 ciphertexts (B, n_in + 1) keyswitched on the key's device
        -> u64 (B, n_out + 1) on the host."""
        from concrete_tpu_torch.core import kernels as kn
        x = torch.from_numpy(np.ascontiguousarray(
            blocks, dtype=np.uint64).view(np.int64)).to(ksk.device)
        return kn.keyswitch(x, ksk).cpu().numpy().view(np.uint64)

    # -- values ------------------------------------------------------------

    def import_value(self, blocks: np.ndarray, input_idx: int) -> np.ndarray:
        """Raw TFHE-rs radix blocks (n_blocks, n+1) u64 -> circuit input.

        Re-encodes each block's phase from the TFHE-rs delta to the circuit's
        native scale by a plaintext multiply (both are powers of two), and —
        when the shared key has a different dimension — keyswitches each
        block into the circuit's big key through the conversion KSK.
        """
        dtype = self.input_types[input_idx]
        circuit_bits = self.circuit.client_specs.input_width(input_idx)
        native_delta_log2 = 64 - circuit_bits - 1
        blocks = np.asarray(blocks, dtype=np.uint64)
        if native_delta_log2 > dtype.delta_log2:
            # native scale coarser: multiply phase up (exact power of two)
            blocks = blocks * np.uint64(
                1 << (native_delta_log2 - dtype.delta_log2))
        elif native_delta_log2 < dtype.delta_log2:
            raise NotImplementedError(
                f"circuit precision ({circuit_bits} bits) exceeds the "
                "TFHE-rs block precision; rescaling down needs a per-block "
                "PBS")
        if self._import_ksk is not None:
            blocks = self._keyswitch(blocks, self._import_ksk)
        return blocks

    def export_value(self, ct: np.ndarray, output_idx: int,
                     dtype: TFHERSIntegerType) -> np.ndarray:
        """Circuit output -> raw TFHE-rs radix blocks (from_native must have
        produced one ciphertext per block); keyswitches back to the shared
        key when dimensions differ.

        The block ciphertexts ship unrescaled, so their native encoding
        delta must equal the TFHE-rs delta — from_native hints each block
        to msg+carry bits to guarantee this; anything else is rejected
        (a phase at the wrong delta decodes to garbage on the other side).
        """
        specs = self.circuit.client_specs
        native_delta_log2 = 64 - specs.output_width(output_idx) - 1
        if native_delta_log2 != dtype.delta_log2:
            raise ValueError(
                f"output {output_idx} is encoded at delta 2^"
                f"{native_delta_log2} but the TFHE-rs dtype expects 2^"
                f"{dtype.delta_log2}; produce the blocks with "
                "tfhers.from_native (it sizes each block to msg+carry "
                "bits)")
        out = np.asarray(ct, dtype=np.uint64)
        if self._export_ksk is not None:
            out = self._keyswitch(out, self._export_ksk)
        return out

    # -- framed bytes (fheint.rs analog, tfhers/serialization.py) -----------

    def import_ciphertext(self, blob: bytes, input_idx: int,
                          format: str = "auto") -> np.ndarray:
        """Serialized radix ciphertext bytes -> circuit input array.

        format: "ctrx" (this framework's framing), "tfhers" (tfhe-rs 0.10
        safe_serialization bincode, tfhers/bincode.py — byte-level caveats
        in docs/tfhers_wire.md), or "auto" (sniff the CTRX magic).
        """
        if format == "auto":
            format = "ctrx" if blob[:4] == b"CTRX" else "tfhers"
        if format == "tfhers":
            from concrete_tpu_torch.tfhers.bincode import deserialize_fheuint
            radix = deserialize_fheuint(blob)
        else:
            radix = deserialize_radix(blob)
        dtype = self.input_types[input_idx]
        if radix.message_modulus != dtype.msg_modulus:
            raise ValueError(
                f"radix ciphertext message_modulus {radix.message_modulus} "
                f"does not match the declared dtype ({dtype.msg_modulus})")
        if radix.n_blocks != dtype.n_blocks:
            raise ValueError(
                f"radix ciphertext has {radix.n_blocks} blocks, dtype "
                f"expects {dtype.n_blocks}")
        return self.import_value(radix.blocks, input_idx)

    def export_ciphertext(self, cts, output_idx: int,
                          dtype: TFHERSIntegerType,
                          format: str = "ctrx") -> bytes:
        """Circuit block outputs -> serialized radix ciphertext bytes
        (format as in import_ciphertext; "auto" not meaningful here)."""
        blocks = np.stack([np.asarray(c, dtype=np.uint64).reshape(-1)
                           for c in (cts if isinstance(cts, (tuple, list))
                                     else [cts])])
        blocks = self.export_value(blocks, output_idx, dtype)
        radix = radix_from_blocks(blocks, dtype)
        if format == "tfhers":
            from concrete_tpu_torch.tfhers.bincode import serialize_fheuint
            return serialize_fheuint(radix, dtype.bit_width)
        return serialize_radix(radix)

    def serialize_input_secret_key(self, input_idx: int) -> bytes:
        key = self._shared_key if self._shared_key is not None \
            else self.circuit.keys.secret.lwe_big
        return np.asarray(key, dtype="<u8").tobytes()


def new_bridge(circuit, input_types: dict[int, TFHERSIntegerType] = None
               ) -> Bridge:
    return Bridge(circuit, input_types or {})
