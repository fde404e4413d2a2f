"""Model circuits over ``concrete_tpu_torch`` (counterparts of
``concrete_tpu/models``; ``PrimeMatch`` and ``HammingDistance(via="xor")``
compile to multi-partition circuits, served like the rest; ``Sha1`` is an
``fhe.module`` of six composed functions; ``KeyValueDatabase``, Concrete's
chunked key-value database, has no counterpart there)."""

from concrete_tpu_torch.models.mlp import QuantizedMLP
from concrete_tpu_torch.models.game_of_life import GameOfLife
from concrete_tpu_torch.models.levenshtein import LevenshteinDistance
from concrete_tpu_torch.models.kvdb import (KeyValueDatabase,
                                             StaticKeyValueDatabase)
from concrete_tpu_torch.models.xor_distance import HammingDistance
from concrete_tpu_torch.models.pir import PrivateInformationRetrieval
from concrete_tpu_torch.models.prime_match import PrimeMatch
from concrete_tpu_torch.models.sha1 import Sha1

__all__ = ["QuantizedMLP", "GameOfLife", "LevenshteinDistance",
           "StaticKeyValueDatabase", "KeyValueDatabase", "HammingDistance",
           "PrivateInformationRetrieval", "PrimeMatch", "Sha1"]
