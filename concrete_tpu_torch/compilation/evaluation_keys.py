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

_FORMAT_VERSION = 1


@dataclasses.dataclass
class EvaluationKeys:
    """bsk (n, l, k+1, k+1, N) u64, ksk (n_big, ks_l, n_small+1) u64,
    optional PFPKSKs keyed by (level, base_log) (carried, not used)."""
    params: CryptoParams
    bsk: np.ndarray
    ksk: np.ndarray
    pfpksk: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_keys(cls, keys) -> "EvaluationKeys":
        return cls(params=keys.params, bsk=np.asarray(keys.server.bsk),
                   ksk=np.asarray(keys.server.ksk),
                   pfpksk=dict(keys._pfpksk))

    def packed(self, message_bits: Optional[int] = None, norm2: float = 1,
               device=None):
        """(LimbKSK, LimbBSK) on `device` (default CUDA) for Server.run,
        with the JAX package's truncation policy; cached per arguments."""
        from concrete_tpu_torch.compilation.keys import (pack_evaluation,
                                                         resolve_device)
        device = resolve_device(device)
        key = (message_bits, float(norm2), str(device))
        cache = self.__dict__.setdefault("_packed_cache", {})
        if key not in cache:
            cache[key] = pack_evaluation(self.params, self.bsk, self.ksk,
                                         message_bits, norm2, device)
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
