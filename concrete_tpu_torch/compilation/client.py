"""Client: keygen, encrypt, decrypt — host-side numpy.

Counterpart of ``concrete_tpu/compilation/client.py``: the same encoding,
the same ChaCha20 randomness and the same u64 ciphertext arrays (*shape,
n_big + 1), so either package's client can talk to either package's
server.  A multi-partition circuit's inputs encrypt under their input
partition's big key and its outputs decrypt under their output
partition's (``MultiKeys``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from concrete_tpu_torch.compilation.keys import Keys, MultiKeys
from concrete_tpu_torch.compilation.specs import ClientSpecs
from concrete_tpu_torch.core import compression as cz
from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import refimpl as ref
from concrete_tpu_torch.dtypes import Integer


class Client:
    def __init__(self, specs: ClientSpecs, keys=None, device=None):
        """`keys`: a ``Keys`` (mono) or ``MultiKeys``; by default a new
        keyset for the specs (every partition's full keys if multi).
        `device`: where the key bodies are computed (``Keys.generate``;
        None: CUDA, which a key generation then needs)."""
        self.specs = specs
        if keys is None:
            keys = MultiKeys(specs.partitions, specs.conversions or {}) \
                if specs.is_multi else Keys(specs.params)
        self.keys = keys
        self.device = device

    def keygen(self, force: bool = False, seed: Optional[int] = None) -> None:
        if force or not self.keys.are_generated:
            self.keys.generate(seed, device=self.device)

    @property
    def evaluation_keys(self):
        """Public key material for the server: serializable, secret-free;
        with the PFPKSK a WoP circuit needs (generated at first use).  A
        multi-partition keyset is refused, as in the JAX package."""
        from concrete_tpu_torch.compilation.evaluation_keys import \
            EvaluationKeys
        self.keygen()
        if isinstance(self.keys, MultiKeys):
            return EvaluationKeys.from_keys(self.keys)
        wp = self.specs.wop_params()
        if wp is not None:
            self.keys.wop_keys(wp, device=self.device)
        return self.keys.evaluation_keys

    def encrypt(self, *args, compress: bool = False):
        """Encrypt positional arguments (clear args pass through) into u64
        LWE arrays of shape (*value_shape, n_big + 1), or with `compress`
        into ``SeededLweCiphertext`` (bodies and a seed from os.urandom;
        the masks grow back from the seed, ``core/compression.py``)."""
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
            sk, std = self._secret_for(self.specs.input_partition(pos))
            enc = ref.encode(arr, self.specs.input_width(pos))
            if compress:
                out.append(cz.encrypt_seeded(rng, sk, enc, std,
                                             seed=os.urandom(32)))
            else:
                out.append(kg.encrypt_lwe_batch(rng, sk, enc, std))
        return tuple(out) if len(out) != 1 else out[0]

    def _secret_for(self, width: int):
        """(big LWE secret key, encryption std) of a partition id (mono:
        the single keyset).  Fresh inputs encrypt under the BIG key, whose
        curve-minimal noise is glwe_std: the small key's much larger
        lwe_std would drown levelled circuits in fresh noise."""
        if isinstance(self.keys, MultiKeys):
            return (self.keys.secret_for(width).lwe_big,
                    self.specs.params_for_width(width).glwe_std)
        return self.keys.secret.lwe_big, self.specs.params.glwe_std

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
            sk, _ = self._secret_for(self.specs.output_partition(pos))
            phase = ref.lwe_decrypt(sk, np.asarray(res))
            signed = isinstance(spec.dtype, Integer) and spec.dtype.is_signed
            val = ref.decode(phase, self.specs.output_width(pos),
                             signed=signed)
            out.append(val if spec.shape or np.ndim(val) else val[()])
        return tuple(out) if len(out) != 1 else out[0]
