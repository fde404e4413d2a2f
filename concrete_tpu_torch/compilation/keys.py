"""Key management: generation, save/load, packing for the device.

Counterpart of ``concrete_tpu/compilation/keys.py`` ``Keys`` and
``MultiKeys``: the same ChaCha20 keygen (same seed, same keys, secret-only
keysets included), the same data-only npz format, and the same BSK
truncation.  Packing puts the key material on a torch device in the form
the JAX package would pick: int8 limb planes for the banded blind rotate
or per-prime NTT spectra for the fused CRT-NTT one.

The insecure key cache (``cache_directory``) is the JAX package's: one npz
of PLAINTEXT SECRET KEYS per keyset, named by the sha256 of the same
``repr`` of (parameters, seed[, secret_only]), so a file that either
package writes loads in the other.  A keyset from an injected GLWE key is
never cached.

The device packs are built at first use and cached; one lock per keyset
guards each cache, so that concurrent first calls (``Circuit.run_async``
on the scheduler's threads) build one pack and share it.

The GLWE key bodies are computed on a torch device (``core.keygen.
keygen_device``, ``core.wop.pfpksk_gen_device``): the BSK's on the
`device` given to ``generate``, the PFPKSK's on the device it is packed
for, where it stays (8.6 GB as u64 at PIR over 64 rows).  A PFPKSK comes
to the host only when a caller saves or serializes it (``wop_keys``,
``save``, the key cache, ``EvaluationKeys.from_keys``): recombined from
its packed limbs, which hold it exactly.  ``setup_seconds`` keeps the
last generation's parts: draws, product, pack, each the duration of its
span (``utils/telemetry``: ``keygen.*``, ``pack``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import threading
from typing import Optional

import numpy as np

from concrete_tpu_torch.core import keygen as kg
from concrete_tpu_torch.core import kernels as kn
from concrete_tpu_torch.core.refimpl import SecretKeys, ServerKeys
from concrete_tpu_torch.params import CryptoParams, choose_truncate_limbs
from concrete_tpu_torch.utils import telemetry as tm
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


def _synchronize(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


class Keys:
    """Client secret keys + server evaluation keys for one parameter set."""

    _FORMAT_VERSION = 1

    def __init__(self, params: CryptoParams,
                 cache_directory: Optional[str] = None):
        self.params = params
        self.cache_directory = cache_directory
        self._seed = None
        self._foreign_key = False
        self._secret: Optional[SecretKeys] = None
        self._server: Optional[ServerKeys] = None
        # WoP packing keys (u64), one per (pfks_level, pfks_base_log)
        self._pfpksk: dict[tuple, np.ndarray] = {}
        self._packed: dict = {}
        self._packed_pfpksk: dict = {}
        # held while a pack is built: concurrent first calls build it once
        self._pack_lock = threading.RLock()
        #: seconds of the last key generation by key and part ("bsk":
        #: draws, product, copy to the host; the KSK's; "pfpksk": draws,
        #: product, pack) and of the last BSK pack
        self.setup_seconds: dict = {}

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

    def generate(self, seed: Optional[int] = None,
                 glwe_key: Optional[np.ndarray] = None,
                 secret_only: bool = False, device=None) -> None:
        """All key material from the ChaCha20 CSPRNG, seeded from
        os.urandom by default and deterministically from `seed`; with a
        cache directory, loaded from its file where one exists, else
        generated and saved there.  The BSK's bodies are computed on
        `device` (None: CUDA, which must then be available), bit for bit
        the host numpy keygen's from the same seed.

        `glwe_key` injects an externally shared big secret key; such a
        keyset is never cached.  `secret_only` skips the evaluation keys
        (BSK/KSK): a partition that runs no PBS only ever encrypts and
        decrypts, and a BSK at its parameters can be GBs.  Its secret keys
        are the first draws of the same stream, so they equal a full
        keyset's from the same seed."""
        with tm.span("keygen") if tm.on else tm.OFF:
            self._generate(seed, glwe_key, secret_only, device)

    def _generate(self, seed, glwe_key, secret_only: bool, device) -> None:
        from concrete_tpu_torch.core.refimpl import sample_binary_key
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        self._seed = seed
        self._foreign_key = glwe_key is not None
        if self.cache_directory is not None and glwe_key is None:
            path = self._cache_path(seed, secret_only)
            if os.path.exists(path):
                self.load(path)
                return
        rng = SecureGenerator(seed)
        if secret_only:
            p = self.params
            sk_small = sample_binary_key(rng, (p.n_small,))
            gsk = sample_binary_key(rng, (p.glwe_dimension,
                                          p.polynomial_size)) \
                if glwe_key is None else np.asarray(
                    glwe_key, dtype=np.uint64).reshape(
                        p.glwe_dimension, p.polynomial_size)
            self._secret = SecretKeys(lwe_small=sk_small, glwe=gsk)
            self._server = None
        else:
            timings = {}
            self._secret, self._server = kg.keygen_device(
                rng, self.params, resolve_device(device), glwe_key=glwe_key,
                timings=timings)
            ksk_s = timings.pop("ksk_s")
            self.setup_seconds = {"bsk": timings, "ksk_s": ksk_s}
        self._packed = {}
        self._pfpksk = {}
        self._packed_pfpksk = {}
        if self.cache_directory is not None and glwe_key is None:
            os.makedirs(self.cache_directory, exist_ok=True)
            self.save(self._cache_path(seed, secret_only))

    def _cache_path(self, seed, secret_only: bool = False) -> str:
        """The cache file of a keyset: the JAX package's name for it."""
        h = hashlib.sha256(
            repr((self.params, seed, secret_only)).encode()).hexdigest()[:24]
        return os.path.join(self.cache_directory, f"keys_{h}.npz")

    @property
    def secret(self) -> SecretKeys:
        self._require()
        return self._secret

    @property
    def server(self) -> ServerKeys:
        self._require()
        if self._server is None:
            raise RuntimeError(
                "this keyset was generated secret-only (a PBS-less "
                "partition); it has no evaluation keys")
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
        with self._pack_lock:
            if key not in self._packed:
                from concrete_tpu_torch.optimizer.v0 import use_fused
                form = "fused" if use_fused(self.params, message_bits) \
                    else "banded"
                with tm.timed("pack", form=form) as t:
                    self._packed[key] = pack_evaluation(
                        self.params, self.server.bsk, self.server.ksk,
                        message_bits, norm2, device)
                    _synchronize(device)
                self.setup_seconds["pack_s"] = t.seconds
            return self._packed[key]

    def _make_pfpksk(self, wop_params, device):
        """A new PFPKSK's u64 bits on `device` (``core/wop.
        pfpksk_gen_device`` from the ChaCha20 CSPRNG seeded from
        os.urandom, as the JAX package's ``Keys.wop_evaluation`` does)."""
        from concrete_tpu_torch.core import wop
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        self._require()
        timings = {}
        key = wop.pfpksk_gen_device(SecureGenerator(), self._secret,
                                    wop_params, device, timings=timings)
        self.setup_seconds["pfpksk"] = timings
        return key

    def wop_keys(self, wop_params, device=None) -> np.ndarray:
        """The u64 PFPKSK of `wop_params`' pfks gadget on the host, for a
        caller that saves or ships it: the packed key's bits, the key made
        and packed first on `device` (None: CUDA) where there is none."""
        self._require()
        key = (wop_params.pfks_level, wop_params.pfks_base_log)
        with self._pack_lock:
            if key not in self.host_pfpksks():
                self.wop_evaluation(wop_params, device)
            return self.host_pfpksks()[key]

    def _refresh_cache(self) -> None:
        """Write the cached keyset again, so that a new PFPKSK is not
        generated again (never one from an injected key)."""
        if self.cache_directory is not None and not self._foreign_key:
            path = self._cache_path(self._seed)
            if os.path.exists(path):
                self.save(path)

    def wop_evaluation(self, wop_params, device=None):
        """The PFPKSK packed as int8 limb planes on `device` (default
        CUDA); cached.  One key per pfks gadget: packed from the host copy
        where there is one (a loaded keyset), else copied from its pack on
        another device, else made on `device` and handed to the pack there
        (``kernels_wop.pack_pfpksk``)."""
        from concrete_tpu_torch.core import kernels_wop as kw
        device = resolve_device(device)
        gadget = (wop_params.pfks_level, wop_params.pfks_base_log)
        key = gadget + (str(device),)
        with self._pack_lock:
            if key in self._packed_pfpksk:
                return self._packed_pfpksk[key]
            other = next((p for k, p in self._packed_pfpksk.items()
                          if k[:2] == gadget), None)
            if gadget in self._pfpksk:
                packed = kw.pack_pfpksk(self._pfpksk[gadget], wop_params,
                                        device=device)
            elif other is not None:
                packed = dataclasses.replace(
                    other, planes=other.planes.to(device))
            else:
                made = self._make_pfpksk(wop_params, device)
                with tm.timed("pack", key="pfpksk") as t:
                    packed = kw.pack_pfpksk(made, wop_params, device=device)
                    del made
                    _synchronize(device)
                self.setup_seconds["pfpksk"]["pack_s"] = t.seconds
            self._packed_pfpksk[key] = packed
            if other is None and gadget not in self._pfpksk:
                self._refresh_cache()
            return packed

    def host_pfpksks(self) -> dict:
        """Every PFPKSK of the keyset as u64 on the host, by (level,
        base_log): the packed ones' bits copied back where needed."""
        from concrete_tpu_torch.core import kernels_wop as kw
        self._require()
        with self._pack_lock:
            for (lev, base, dev), packed in list(
                    self._packed_pfpksk.items()):
                if (lev, base) not in self._pfpksk:
                    self._pfpksk[(lev, base)] = kw.unpack_pfpksk(
                        packed, self.params.n_big + 1)
            return dict(self._pfpksk)

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
        for (lev, base), pfpksk in self.host_pfpksks().items():
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


class MultiKeys:
    """Keysets for a multi-partition circuit: one ``Keys`` per partition id
    plus the big->big conversion keyswitch keys of the partition frontiers
    (the JAX package's ``MultiKeys``, after the reference optimizer's
    keys_spec.rs CircuitKeys).  Saved as one npz covering every partition
    and conversion, in the JAX package's format."""

    def __init__(self, partitions: dict, conversions: dict,
                 cache_directory: Optional[str] = None, pbs_widths=None):
        """partitions: id -> CryptoParams; conversions: (src, dst) ->
        (level, base_log); pbs_widths: the partitions that run a PBS (None
        = all), the others get secret-only keysets; cache_directory: the
        insecure key cache, one file for every partition and conversion."""
        self.partitions = dict(partitions)
        self.conversions = dict(conversions)
        self.cache_directory = cache_directory
        self.pbs_widths = frozenset(pbs_widths) \
            if pbs_widths is not None else None
        self._keys: dict[int, Keys] = {
            w: Keys(p) for w, p in self.partitions.items()}
        self._fks: dict[tuple, np.ndarray] = {}
        self._packed_fks: dict = {}
        self._pack_lock = threading.Lock()

    def _needs_eval(self, w: int) -> bool:
        return self.pbs_widths is None or w in self.pbs_widths

    @property
    def are_generated(self) -> bool:
        return all(k.are_generated for k in self._keys.values()) \
            and set(self._fks) == set(self.conversions)

    def generate(self, seed: Optional[int] = None, device=None) -> None:
        """Each partition's keyset from its own seed (seed + 7919 w, so
        that partitions of equal parameters never share secrets), its BSK
        computed on `device` (None: CUDA), then the conversion keys in
        order from one stream seeded seed + 13: src's big key to dst's big
        key at dst's GLWE noise (LWE keys: host numpy).  With a cache
        directory, loaded from its file where one exists, else saved
        there."""
        from concrete_tpu_torch.utils.csprng import SecureGenerator
        if self.cache_directory is not None:
            path = self._cache_path(seed)
            if os.path.exists(path):
                self.load(path)
                return
        for w, keys in self._keys.items():
            keys.generate(None if seed is None else seed + 7919 * w,
                          secret_only=not self._needs_eval(w), device=device)
        self._fks = {}
        self._packed_fks = {}
        rng = SecureGenerator(None if seed is None else seed + 13)
        for (s, d), (lvl, base) in self.conversions.items():
            self._fks[(s, d)] = kg.make_ksk(
                rng, self._keys[s].secret.lwe_big,
                self._keys[d].secret.lwe_big, base, lvl,
                self.partitions[d].glwe_std)
        if self.cache_directory is not None:
            os.makedirs(self.cache_directory, exist_ok=True)
            self.save(self._cache_path(seed))

    def _cache_path(self, seed) -> str:
        """The cache file of the keysets: the JAX package's name for it."""
        h = hashlib.sha256(repr((sorted(self.pbs_widths)
                                  if self.pbs_widths is not None else None,
                                  sorted(self.partitions.items()),
                                  sorted(self.conversions.items()),
                                  seed)).encode()).hexdigest()[:24]
        return os.path.join(self.cache_directory, f"multikeys_{h}.npz")

    # -- accessors ---------------------------------------------------------

    def keys_for(self, width: int) -> Keys:
        return self._keys[width]

    def secret_for(self, width: int):
        return self._keys[width].secret

    def evaluation_for_width(self, width: int, norm2: float = 1,
                             device=None):
        """Packed (LimbKSK, LimbBSK or FusedBSK) of one partition id, its
        BSK truncated at the partition's own message width (a norm2-cut id
        carries the width in its low byte)."""
        from concrete_tpu_torch.compilation.widths import part_width
        return self._keys[width].evaluation_for(part_width(width),
                                                norm2=norm2, device=device)

    def conversion_key(self, src: int, dst: int, device=None) -> kn.LimbKSK:
        """The packed big->big conversion keyswitch key of a frontier, on
        `device` (CUDA by default): uploaded as u64 and split into int8
        limb planes there (``kernels_wop.split_u64_limbs``, bit for bit the
        host's ``limbs.u64_to_balanced_i8``), at the frontier's own
        gadget."""
        import torch
        from concrete_tpu_torch.core.kernels_wop import split_u64_limbs
        device = resolve_device(device)
        key = (src, dst, str(device))
        with self._pack_lock:
            if key not in self._packed_fks:
                lvl, base = self.conversions[(src, dst)]
                u64 = torch.from_numpy(np.ascontiguousarray(
                    self._fks[(src, dst)], dtype=np.uint64).view(np.int64))
                self._packed_fks[key] = kn.LimbKSK(
                    planes=split_u64_limbs(u64.to(device)), base_log=base,
                    levels=lvl)
            return self._packed_fks[key]

    def wop_evaluation_for(self, width: int, wop_params, device=None):
        return self._keys[width].wop_evaluation(wop_params, device=device)

    # -- serialization (the JAX package's npz format) -----------------------

    def _to_npz_dict(self) -> dict:
        header = {"version": Keys._FORMAT_VERSION,
                  "partitions": sorted(self.partitions),
                  "conversions": [[s, d, l, b] for (s, d), (l, b)
                                  in sorted(self.conversions.items())]}
        out = {"multi_header": np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8)}
        for w, keys in self._keys.items():
            for name, arr in keys._to_npz_dict().items():
                out[f"p{w}__{name}"] = arr
        for (s, d), arr in self._fks.items():
            out[f"fks_{s}_{d}"] = arr
        return out

    def _from_npz(self, z) -> None:
        header = json.loads(bytes(np.asarray(z["multi_header"])).decode())
        if header.get("version", 0) > Keys._FORMAT_VERSION:
            raise ValueError("key file format is newer than this library")
        for w, keys in self._keys.items():
            keys._from_npz(_Prefixed(z, f"p{w}__"))
        self._fks = {}
        self._packed_fks = {}
        for name in z.files:
            if name.startswith("fks_"):
                _, s, d = name.split("_")
                self._fks[(int(s), int(d))] = np.asarray(z[name])

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            np.savez(f, **self._to_npz_dict())

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            self._from_npz(z)

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **self._to_npz_dict())
        return buf.getvalue()

    @classmethod
    def deserialize_with(cls, blob: bytes, partitions: dict,
                         conversions: dict) -> "MultiKeys":
        keys = cls(partitions, conversions)
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            keys._from_npz(z)
        return keys


class _Prefixed:
    """One partition's entries of a multi-keyset npz, under their mono
    names."""

    def __init__(self, z, prefix: str):
        self.z, self.prefix = z, prefix
        self.files = [n[len(prefix):] for n in z.files
                      if n.startswith(prefix)]

    def __getitem__(self, name):
        return self.z[self.prefix + name]
