"""TFHE-rs interop: radix integer types, to/from native, the bridge.

Counterpart of ``concrete_tpu/tfhers/``, with the same names.
"""

from concrete_tpu_torch.tfhers.dtypes import (TFHERSIntegerType,
                                              CryptoParams as
                                              TFHERSCryptoParams, uint8_2_2,
                                              uint16_2_2, int8_2_2)
from concrete_tpu_torch.tfhers.bridge import Bridge, new_bridge
from concrete_tpu_torch.tfhers.ops import to_native, from_native

__all__ = ["TFHERSIntegerType", "TFHERSCryptoParams", "uint8_2_2",
           "uint16_2_2", "int8_2_2", "Bridge", "new_bridge", "to_native",
           "from_native"]
