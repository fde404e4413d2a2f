from concrete_tpu_torch.tracing.tracer import Tracer

__all__ = ["Tracer"]
