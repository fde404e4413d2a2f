"""Model circuits over ``concrete_tpu_torch`` (counterparts of
``concrete_tpu/models``; the others are ROADMAP queue 1 item 5)."""

from concrete_tpu_torch.models.mlp import QuantizedMLP

__all__ = ["QuantizedMLP"]
