"""Client: keygen, encrypt, decrypt — host-side numpy.

Counterpart of ``concrete_tpu/compilation/client.py`` for mono-keyset
circuits: the same encoding, the same ChaCha20 randomness and the same u64
ciphertext arrays (*shape, n_big + 1), so either package's client can talk
to either package's server.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from concrete_tpu_torch.compilation.keys import Keys
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.dtypes import Integer


class Client:
    def __init__(self, specs: ClientSpecs, keys: Optional[Keys] = None):
        if specs.is_multi:
            raise NotImplementedError(
                "multi-partition circuits are not ported yet "
                "(ROADMAP queue 1 item 8)")
        self.specs = specs
        self.keys = keys if keys is not None else Keys(specs.params)

    def keygen(self, force: bool = False, seed: Optional[int] = None) -> None:
        if force or not self.keys.are_generated:
            self.keys.generate(seed)

    @property
    def evaluation_keys(self):
        """Public key material for the server: serializable, secret-free;
        with the PFPKSK a WoP circuit needs (generated at first use)."""
        self.keygen()
        wp = self.specs.wop_params()
        if wp is not None:
            self.keys.wop_keys(wp)
        return self.keys.evaluation_keys

    def encrypt(self, *args):
        """Encrypt positional arguments (clear args pass through) into u64
        LWE arrays of shape (*value_shape, n_big + 1)."""
        self.keygen()
        if len(args) != len(self.specs.inputs):
            raise ValueError(
                f"expected {len(self.specs.inputs)} argument(s), "
                f"got {len(args)}")
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        rng = SecureGenerator()
        out = []
        for pos, arg in enumerate(args):
            spec = self.specs.inputs[pos]
            arr = np.asarray(arg, dtype=np.int64)
            self._validate(arr, spec, pos)
            if not spec.is_encrypted:
                out.append(np.asarray(arg))
                continue
            # fresh inputs encrypt under the big key at the GLWE noise
            enc = ref.encode(arr, self.specs.input_width(pos))
            out.append(kg.encrypt_lwe_batch(rng, self.keys.secret.lwe_big,
                                            enc, self.specs.params.glwe_std))
        return tuple(out) if len(out) != 1 else out[0]

    def _validate(self, arr, spec, pos):
        dtype = spec.dtype
        if isinstance(dtype, Integer):
            if arr.size and (arr.min() < dtype.min or arr.max() > dtype.max):
                raise ValueError(
                    f"argument {pos} has value(s) outside the compiled range "
                    f"[{dtype.min}, {dtype.max}] (got "
                    f"[{arr.min()}, {arr.max()}])")
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(
                f"argument {pos} has shape {arr.shape}, expected {spec.shape}")

    def decrypt(self, *results):
        if not self.keys.are_generated:
            # never auto-generate here: decrypting under a fresh keyset
            # would silently decode noise into plausible-looking integers
            raise RuntimeError("keys are not generated/loaded; call keygen() "
                               "or Keys.load() first")
        out = []
        for pos, res in enumerate(results):
            spec = self.specs.outputs[pos]
            phase = ref.lwe_decrypt(self.keys.secret.lwe_big,
                                    np.asarray(res))
            signed = isinstance(spec.dtype, Integer) and spec.dtype.is_signed
            val = ref.decode(phase, self.specs.output_width(pos),
                             signed=signed)
            out.append(val if spec.shape or np.ndim(val) else val[()])
        return tuple(out) if len(out) != 1 else out[0]
