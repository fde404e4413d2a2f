from concrete_tpu_torch.compilation.client import Client
from concrete_tpu_torch.compilation.evaluation_keys import EvaluationKeys
from concrete_tpu_torch.compilation.keys import Keys
from concrete_tpu_torch.compilation.server import Server

__all__ = ["Client", "EvaluationKeys", "Keys", "Server"]
