"""Transport values: serializable ciphertext/clear containers.

Reference: the compiler's Value/TransportValue (lib/Common/Values.cpp,
capnp-framed) exchanged between Client and Server.  Here a Value wraps a
numpy array with a small JSON header; `serialize` produces a self-describing
byte string (our stand-in for the capnp schema's payload framing,
tools/concrete-protocol/concrete-protocol.capnp `Value`).
"""

from __future__ import annotations

import json
import struct

import numpy as np

_MAGIC = b"CTPV1\0"


class Value:
    def __init__(self, inner: np.ndarray, is_encrypted: bool = True):
        self.inner = np.asarray(inner)
        self.is_encrypted = is_encrypted

    def serialize(self) -> bytes:
        header = json.dumps({
            "dtype": str(self.inner.dtype),
            "shape": list(self.inner.shape),
            "is_encrypted": self.is_encrypted,
        }).encode()
        return (_MAGIC + struct.pack("<I", len(header)) + header
                + self.inner.tobytes())

    @classmethod
    def deserialize(cls, blob: bytes) -> "Value":
        if blob[:6] != _MAGIC:
            raise ValueError("not a concrete_tpu Value payload")
        (hlen,) = struct.unpack("<I", blob[6:10])
        header = json.loads(blob[10:10 + hlen].decode())
        data = np.frombuffer(blob[10 + hlen:], dtype=header["dtype"])
        return cls(data.reshape(header["shape"]).copy(),
                   header["is_encrypted"])

    def __eq__(self, other):
        return (isinstance(other, Value)
                and self.is_encrypted == other.is_encrypted
                and np.array_equal(self.inner, other.inner))


TransportValue = Value
