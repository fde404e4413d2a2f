"""Model circuits over ``concrete_tpu_torch`` (counterparts of
``concrete_tpu/models``; ``PrimeMatch`` compiles multi-partition and waits
for ROADMAP queue 1 item 8, ``Sha1`` needs ``fhe.module``, the rest of
item 6)."""

from concrete_tpu_torch.models.mlp import QuantizedMLP
from concrete_tpu_torch.models.game_of_life import GameOfLife
from concrete_tpu_torch.models.levenshtein import LevenshteinDistance
from concrete_tpu_torch.models.kvdb import StaticKeyValueDatabase
from concrete_tpu_torch.models.xor_distance import HammingDistance
from concrete_tpu_torch.models.pir import PrivateInformationRetrieval

__all__ = ["QuantizedMLP", "GameOfLife", "LevenshteinDistance",
           "StaticKeyValueDatabase", "HammingDistance",
           "PrivateInformationRetrieval"]
