"""The port's copy of the JAX package's parameter search (``v0``)."""

from concrete_tpu_torch.optimizer.v0 import optimize_v0, optimize_v0_multi

__all__ = ["optimize_v0", "optimize_v0_multi"]
