"""EvaluationKeys: the PUBLIC key material a client ships to a server.

Counterpart of ``concrete_tpu/compilation/evaluation_keys.py``, with the
same npz wire format (versioned JSON header, raw u64 ``bsk`` and ``ksk``,
optional ``pfpksk_<level>_<base>`` arrays; allow_pickle=False), so blobs
move between the two packages in either direction.  The server packs the
raw keys for its device on arrival.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import Optional

import numpy as np

from concrete_tpu_torch.params import CryptoParams
from concrete_tpu_torch.utils.device import resolve_device

_FORMAT_VERSION = 1


@dataclasses.dataclass
class EvaluationKeys:
    """bsk (n, l, k+1, k+1, N) u64, ksk (n_big, ks_l, n_small+1) u64,
    optional PFPKSKs keyed by (level, base_log)."""
    params: CryptoParams
    bsk: np.ndarray
    ksk: np.ndarray
    pfpksk: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_keys(cls, keys) -> "EvaluationKeys":
        """The public material of a generated mono ``Keys``."""
        from concrete_tpu_torch.compilation.keys import MultiKeys
        if isinstance(keys, MultiKeys):
            raise NotImplementedError(
                "EvaluationKeys covers mono keysets; multi-partition "
                "deployments currently ship Circuit._evaluation_keys "
                "(per-partition packed keys) directly")
        return cls(params=keys.params, bsk=np.asarray(keys.server.bsk),
                   ksk=np.asarray(keys.server.ksk),
                   pfpksk=keys.host_pfpksks())

    def packed(self, message_bits: Optional[int] = None, norm2: float = 1,
               device=None, wop_params=None):
        """(LimbKSK, LimbBSK or FusedBSK) on `device` (default CUDA) for
        Server.run, with the JAX package's BSK form and truncation policy,
        and the packed PFPKSK of `wop_params` as a third element (a WoP
        circuit packs the untruncated BSK: its server passes
        ``message_bits=None``); cached per arguments."""
        from concrete_tpu_torch.compilation.keys import pack_evaluation
        device = resolve_device(device)
        wop_key = None if wop_params is None else \
            (wop_params.pfks_level, wop_params.pfks_base_log)
        key = (message_bits, float(norm2), str(device), wop_key)
        cache = self.__dict__.setdefault("_packed_cache", {})
        if key not in cache:
            out = pack_evaluation(self.params, self.bsk, self.ksk,
                                  message_bits, norm2, device)
            if wop_params is not None:
                from concrete_tpu_torch.core import kernels_wop as kw
                if wop_key not in self.pfpksk:
                    raise ValueError(
                        f"evaluation keys carry no PFPKSK for gadget "
                        f"{wop_key}; regenerate them from a keyset with WoP "
                        "keys")
                out = out + (kw.pack_pfpksk(self.pfpksk[wop_key], wop_params,
                                            device=device),)
            cache[key] = out
        return cache[key]

    def serialize(self) -> bytes:
        header = {"version": _FORMAT_VERSION,
                  "params": dataclasses.asdict(self.params)}
        out = {"header": np.frombuffer(json.dumps(header).encode(),
                                       dtype=np.uint8),
               "bsk": self.bsk, "ksk": self.ksk}
        for (lev, base), arr in self.pfpksk.items():
            out[f"pfpksk_{lev}_{base}"] = arr
        buf = io.BytesIO()
        np.savez(buf, **out)
        return buf.getvalue()

    @classmethod
    def deserialize(cls, blob: bytes) -> "EvaluationKeys":
        with np.load(io.BytesIO(blob), allow_pickle=False) as z:
            header = json.loads(bytes(np.asarray(z["header"])).decode())
            if header.get("version", 0) > _FORMAT_VERSION:
                raise ValueError(
                    "evaluation-key format is newer than this library")
            pfpksk = {}
            for name in z.files:
                if name.startswith("pfpksk_"):
                    _, lev, base = name.split("_")
                    pfpksk[(int(lev), int(base))] = np.asarray(z[name])
            return cls(params=CryptoParams(**header["params"]),
                       bsk=np.asarray(z["bsk"]), ksk=np.asarray(z["ksk"]),
                       pfpksk=pfpksk)
